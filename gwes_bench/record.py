"""What a run hands to the metric readers (``metrics/<name>.py``).

Each reader is ``read(run: Run) -> float | None``; None leaves the metric
out of the result's line (nothing to read in this run).  The end-to-end
readers are host-clock numbers of the run; the per-layer readers read
the window's scans' stage seconds (the program's ``run_pipeline``
timings, host clock with the device synchronized at each stage's end)
and, in a traced run, the window's trace (``trace.Trace``).  In a run of
several ranks every number but ``peak_bytes`` is rank 0's
(``run.py``'s docstring).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Run:
    samples: int          # sample rows of the scanned alignment
    loci: int             # columns the scans kept (after the filter)
    scans: list           # each window scan's timings dict
    window_s: float       # host seconds from the window's start to its last scan's end
    setup_s: float        # process start to the window's start
    peak_bytes: int       # torch.cuda.max_memory_allocated over the window
    device_name: str
    trace: object = None  # trace.Trace of the window, in a traced run
    # in a run of several ranks, each window scan's (tile, block-row starts)
    # that the program dealt rank 0's sweep; None with one rank, whose sweep
    # covers every pair
    swept_rows: list | None = None

    def mean(self, *keys: str) -> float | None:
        """The mean over the scans of the sum of their ``keys`` seconds;
        None when a scan lacks one."""
        if not self.scans or any(k not in tm for tm in self.scans for k in keys):
            return None
        return sum(sum(tm[k] for k in keys) for tm in self.scans) / len(self.scans)
