"""setup_s: process start to the window's start: imports, the CUDA
context, the kernel libraries (built in a checkout's first run), the
alignment's generation and files, and one warm-up scan."""


def read(run):
    return run.setup_s
