"""Host helpers of the port: time strings and unique output paths (copies
of ``spydrpick_tpu.utils``), and the spans, counters and profiler trace
of ``profiling.py``."""
