"""Wall-clock stage timers (reference apegrunt misc/Stopwatch.hpp,
used at src/SpydrPick.cpp:157-161 and ARACNE.hpp:424-427)."""

from __future__ import annotations

import time


def time_string(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f}us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.1f}ms"
    if seconds < 60.0:
        return f"{seconds:.2f}s"
    m, s = divmod(seconds, 60.0)
    return f"{int(m)}m{s:.1f}s"


class Stopwatch:
    def __init__(self, out=None):
        self.out = out
        self._t0 = None
        self.elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._t0 is not None:
            self.elapsed = time.perf_counter() - self._t0
        return self.elapsed

    def print_timing_stats(self, label: str = "time"):
        if self.out is not None:
            print(f"  {label}={time_string(self.elapsed)}", file=self.out)

    def __str__(self):
        return time_string(self.elapsed)
