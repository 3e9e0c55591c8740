"""Host helpers of the port: the stopwatch and unique output paths (copies
of ``spydrpick_tpu.utils``) and the torch.profiler trace reader."""
