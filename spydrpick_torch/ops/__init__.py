"""MI math and the two CUDA kernels of the main path: the MI tile
(mi_kernels.py) and the per-row edge compaction (compact.py), each with
its plain PyTorch version and launch counter."""
