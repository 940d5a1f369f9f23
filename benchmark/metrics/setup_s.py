"""Set-up seconds: process start to the window's start (imports, CUDA
set-up, the kernels' load or first build, the world, the matcher, the
warm-up)."""


def read(run):
    return run.setup_s
