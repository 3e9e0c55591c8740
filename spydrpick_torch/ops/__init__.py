"""MI math and the CUDA kernels: the MI tiles (mi_kernels.py) and the
per-block-row edge selection into a device store (compact.py), each with
its plain PyTorch version and launch counter."""
