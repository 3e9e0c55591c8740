"""Sharded sweeps on torch.distributed (port of spydrpick_tpu/parallel)."""
