"""spydrpick_torch — the SpydrPick GWES engine in PyTorch with CUDA kernels.

A port of ``spydrpick_tpu`` (the JAX/Pallas package beside it, which stays
the reference) to PyTorch on one NVIDIA Hopper GPU.  Same stages, flags
and output files: FASTA -> filter -> sample weights -> tournament
threshold -> all-pairs MI sweep -> lazy wo-gaps resolve -> Tukey fences ->
sort -> ARACNE -> write.

Host code that never touched jax is reused from ``spydrpick_tpu`` (the
alignment model, filter, FASTA/loci IO, writers, native ARACNE and
formatter kernels).  Plain XLA code of the reference becomes plain torch
here; the reference's Pallas kernels on the main path become hand-written
CUDA kernels (``csrc/``): the MI tile (``ops/mi_kernels.py``) and the
per-row edge compaction (``ops/compact.py``).  This package never imports
jax.
"""

from spydrpick_torch.version import __version__

__all__ = ["__version__"]
