"""Seconds from process start to the window's start: imports, CUDA
initialisation, the kernels' and the native library's build where the
checkout has none, the database(s) from the seed, and one warm call."""


def read(run):
    return run.setup_s
