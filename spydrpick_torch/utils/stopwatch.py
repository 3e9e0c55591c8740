"""Wall-clock times as the reference prints them (apegrunt
misc/Stopwatch.hpp, used at src/SpydrPick.cpp:157-161 and
ARACNE.hpp:424-427); the port's stage timers are the spans of
``utils/profiling.py``."""

from __future__ import annotations


def time_string(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f}us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.1f}ms"
    if seconds < 60.0:
        return f"{seconds:.2f}s"
    m, s = divmod(seconds, 60.0)
    return f"{int(m)}m{s:.1f}s"
