"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

The sources compile with ``nvcc`` into shared libraries with a plain C
interface, loaded with ctypes: the count kernels' library (``load``:
sn_rect.cu, sn_square_wgmma.cu) and the f64 finish's own (``load_finish``:
finish_f64.cu alone), so that the default exact call, which launches only
the finish, compiles one small file and not the ``wgmma`` sources.  A build
runs at first use, into ``parfastaai_tpu_torch/_build/``, keyed by a hash
of its sources, their shared header and the flags, so a fresh checkout
builds a library the first time it launches one of its kernels and a
rebuilt source never loads a stale library.  Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = [
    os.path.join(_PKG, "csrc", name)
    for name in ("sn_rect.cu", "sn_square_wgmma.cu")
]
# Headers the sources include: hashed with them, so that a changed header
# never loads a stale library.
_HDRS = [os.path.join(_PKG, "csrc", "sn_wgmma.cuh")]
_FINISH_SRCS = [os.path.join(_PKG, "csrc", "finish_f64.cu")]
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_finish_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's stderr of the last build this process ran (ptxas)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    NVCC_DEFAULT.  Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append(NVCC_DEFAULT)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _tag(srcs: list[str] | None = None,
         hdrs: list[str] | None = None) -> str:
    """The hash of a library's sources (default: the count kernels'),
    headers and flags."""
    if srcs is None:
        srcs, hdrs = _SRCS, _HDRS
    h = hashlib.sha256()
    for src in srcs + (hdrs or []):
        with open(src, "rb") as fp:
            h.update(fp.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(stem: str = "pfaai_kernels", srcs: list[str] | None = None,
          hdrs: list[str] | None = None) -> str:
    """Compile library ``stem`` from ``srcs`` (default: the count kernels
    and their header) if this source hash has no library yet; returns the
    library path.  One nvcc per source, all started together, then one
    link.  Raises with nvcc's stderr when a step fails."""
    global build_log
    if srcs is None:
        srcs, hdrs = _SRCS, _HDRS
    so_path = os.path.join(BUILD_DIR, f"lib{stem}_{_tag(srcs, hdrs)}.so")
    if os.path.exists(so_path):
        return so_path
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(srcs, objs)
        ]
        steps = [(src, proc, proc.communicate()[1])
                 for src, proc in zip(srcs, procs)]
        for src, proc, err in steps:
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}) building "
                    f"{os.path.basename(src)}:\n{err.strip()}"
                )
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {link.returncode}) linking "
                f"{os.path.basename(so_path)}:\n{link.stderr.strip()}"
            )
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_log = "".join(err for _, _, err in steps)
    os.replace(tmp, so_path)
    return so_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp = ctypes.c_void_p
            ci = ctypes.c_int
            lib.sn_rect_launch.argtypes = [
                vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp,
            ]
            lib.sn_rect_launch.restype = ci
            lib.sn_square_wgmma_launch.argtypes = [
                vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                vp,
            ]
            lib.sn_square_wgmma_launch.restype = ci
            for fn in (lib.sn_rect_error_string,
                       lib.sn_square_wgmma_error_string):
                fn.argtypes = [ci]
                fn.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def load_finish() -> ctypes.CDLL:
    """The f64 finish's library (csrc/finish_f64.cu), built on first call
    (thread-safe)."""
    global _finish_lib
    with _lock:
        if _finish_lib is None:
            lib = ctypes.CDLL(build("pfaai_finish", _FINISH_SRCS, []))
            vp = ctypes.c_void_p
            ci = ctypes.c_int
            ll = ctypes.c_longlong
            lib.finish_f64_launch.argtypes = [
                vp, ci, vp, vp, vp, ll, ll, ll, vp, vp, vp,
            ]
            lib.finish_f64_launch.restype = ci
            lib.finish_f64_error_string.argtypes = [ci]
            lib.finish_f64_error_string.restype = ctypes.c_char_p
            _finish_lib = lib
        return _finish_lib
