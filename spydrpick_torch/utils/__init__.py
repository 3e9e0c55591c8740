"""Tracing helpers of the port (the stopwatch and unique-path helpers are
reused from ``spydrpick_tpu.utils``)."""
