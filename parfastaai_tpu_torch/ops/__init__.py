"""Device operations: the exact int8 Gram (``fused``) and the fused (S, N)
block kernel (``sn_rect``)."""
