"""ParFastAAI on PyTorch: the AJI engine of ``parfastaai_tpu`` ported to
PyTorch and CUDA for NVIDIA Hopper GPUs.

The host side (SQLite ETL, run modes, CSV writer, native f64 finish) is
shared with the JAX package by import; the device side is plain tensor code
plus hand-written CUDA kernels (``csrc/``).  Every entry point takes an
explicit device and never moves to another one.
"""

from parfastaai_tpu import __version__

__all__ = ["__version__"]
