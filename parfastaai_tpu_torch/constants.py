"""Global constants of the port's host side (the names it uses of
``parfastaai_tpu/constants.py``, with the same values).

The tetramer universe is the set of length-4 amino-acid substrings over the
20-letter alphabet, encoded as integers in ``[0, 20**4)`` (reference:
include/pfaai/interface.hpp:233, NTETRAMERS = 160000).
"""

# Number of possible amino-acid tetramers (20**4).
NTETRAMERS: int = 160000

# Default CSV field separator (reference: src/main.cpp:74, default ",").
DEFAULT_SEPARATOR: str = ","

# Presence matrices are padded so the compacted tetramer axis is a multiple
# of this.  The width buckets inherit it, so every K the kernels see on the
# main path is a multiple of their 64-byte slice.
LANE: int = 128

# Widest contraction axis of the JAX package's single-block kernels; the
# width buckets and the bench's kb mode keep its value as the line between
# the two K regimes, so both packages cut the same buckets.  The CUDA
# kernels loop over K and have no such limit.
MAX_K_SINGLE_BLOCK: int = 32768

# Host-side padding granularity for presence buckets wider than
# MAX_K_SINGLE_BLOCK (etl.database.bucket_bounds).
K_BLOCK: int = 4096
