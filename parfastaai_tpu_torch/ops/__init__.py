"""Device operations: the exact int8 Gram (``fused``), the fused (S, N)
block kernel (``sn_rect``) and the public count ops (``intersect``)."""

from .intersect import intersection_counts, pair_counts

__all__ = ["intersection_counts", "pair_counts"]
