"""ParFastAAI on PyTorch: the AJI engine of ``parfastaai_tpu`` ported to
PyTorch and CUDA for NVIDIA Hopper GPUs.

The host side (SQLite ETL, run modes, CSV writer, native f64 finish) is the
package's own copy of the JAX package's host modules, under the same names;
nothing here imports ``parfastaai_tpu`` or ``jax``.  The device side is
plain tensor code plus hand-written CUDA kernels (``csrc/``).  Every entry
point takes an explicit device and never moves to another one.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
