"""spydrpick_torch — the SpydrPick GWES engine in PyTorch with CUDA kernels.

A port of ``spydrpick_tpu`` (the JAX/Pallas package beside it, which stays
the reference) to PyTorch on one NVIDIA Hopper GPU.  Same stages, flags
and output files: FASTA -> filter -> sample weights -> tournament
threshold -> all-pairs MI sweep -> lazy wo-gaps resolve -> Tukey fences ->
sort -> ARACNE -> write.

The reference's host code is copied, not called: the alignment model,
filter, FASTA/loci IO, writers and the native FASTA, ARACNE and formatter
kernels live in ``core``, ``io``, ``utils`` and ``native`` here.  Plain
XLA code of the reference becomes plain torch; the reference's Pallas
kernels become hand-written CUDA kernels (``csrc/``, wrapped in
``ops/mi_kernels.py`` and ``ops/compact.py``).  This package imports
neither jax nor anything of ``spydrpick_tpu``.
"""

from spydrpick_torch.version import __version__

__all__ = ["__version__"]
