"""Several ranks of the program on one host, one card each: a cell whose
``chips`` is N > 1 runs as
``torchrun --nproc-per-node N -m spydrpick_torch aln.fasta --sharded``
runs it.

``run.py`` re-executes itself under ``launcher``'s command: PyTorch's
own launcher (``torch.distributed.run --standalone``) starts N ranks of
``run.py`` with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``
of its own rendezvous, and ``OMP_NUM_THREADS=1`` unless it is set), and
rank r drives ``cuda:r``.  Rank 0 makes the alignment and writes its
FASTA while the other ranks start; then every rank joins through the
program's own ``initialize_distributed`` (the program's backend rule
picks ``nccl`` with a card a rank, ``gloo`` on the CPU) and a ``gloo``
group of the harness's own, the control group, over which rank 0 hands
the others the scan's command line and the run's work directory
(``join``).  Every rank runs the warm-up scan, then in the window one
scan each time rank 0 says to go on (``go``): all ranks run the same
scans in lockstep.  A worker (a rank other than 0, ``worker``) writes
into output directories of its own, which the program leaves empty
(rank 0 alone writes files), prints nothing on standard output, and
after the window sends rank 0 its report (``reports``): its scans'
(edges, threshold, kept columns), its peak device memory since its
warm-up, the JAX modules it holds.

A rank that dies or raises ends the run: the launcher sees it within a
second, stops the other ranks (SIGTERM, SIGKILL 30 s later), names the
rank and its exit code on standard error and exits with code 1; no rank
waits out the program's 10-minute collective timeout.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile


def log(*msg) -> None:
    print("gwes_bench:", *msg, file=sys.stderr, flush=True)


def launcher(n: int, script: str, args: list[str]) -> list[str]:
    """The command that runs ``script args`` as ``n`` ranks on this host."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={n}", script, *args]


def summary(res) -> tuple:
    """What every rank's scan must agree on: (edges, threshold, kept
    columns)."""
    return (res.edges.n_edges, res.mi_threshold, len(res.alignment.translation))


@contextlib.contextmanager
def dealt_rows(into: list):
    """While open, each call of the program's ``MIEngine.sweep_rows``
    (the block-rows that a sweep, one-device or sharded, deals to this
    rank) appends (tile, block-row starts) to ``into``."""
    from spydrpick_torch.engine.solver import MIEngine

    orig = MIEngine.sweep_rows

    def sweep_rows(self, rows, *args, **kwargs):
        into.append((self.tile, list(rows)))
        return orig(self, rows, *args, **kwargs)
    MIEngine.sweep_rows = sweep_rows
    try:
        yield
    finally:
        MIEngine.sweep_rows = orig


def join(argv: list | None = None, work: str | None = None):
    """Join the program's process group and the control group; rank 0
    sends (``argv``, ``work``), every rank returns them with the
    program's summary of the group and the control group."""
    import torch.distributed as dist

    from spydrpick_torch.parallel.distributed import initialize_distributed

    info = initialize_distributed()
    ctrl = dist.new_group(backend="gloo")
    got = [argv, work]
    dist.broadcast_object_list(got, src=0, group=ctrl)
    return got[0], got[1], info, ctrl


def go(ctrl, more: bool) -> bool:
    """Rank 0's decision whether the window runs another scan, which
    every rank returns."""
    import torch
    import torch.distributed as dist

    flag = torch.tensor([1 if more else 0], dtype=torch.int64)
    dist.broadcast(flag, src=0, group=ctrl)
    return bool(flag.item())


def reports(ctrl, mine: dict | None = None) -> list[dict]:
    """After the window: every worker's report gathered on rank 0 (rank 0
    gets the list, a worker passes ``mine`` and gets []), then the process
    group left."""
    import torch.distributed as dist

    from spydrpick_torch.parallel.distributed import shutdown

    got = [None] * dist.get_world_size() if mine is None else None
    dist.gather_object(mine or {}, got, dst=0, group=ctrl)
    shutdown()
    return got[1:] if got else []


def worker() -> int:
    """A worker rank: join, receive the scan, run the warm-up and the
    window's scans as rank 0 says, then send the report."""
    import torch

    from gwes_bench.run import forbidden_modules, scan_options
    from spydrpick_torch.device import default_device
    from spydrpick_torch.pipeline import run_pipeline

    rank = int(os.environ["RANK"])
    devnull = os.open(os.devnull, os.O_WRONLY)
    os.dup2(devnull, 1)  # the result's line is rank 0's alone
    log(f"rank {rank} of {os.environ['WORLD_SIZE']}: pid {os.getpid()}")
    argv, work, _, ctrl = join()
    outputs = os.path.join(work, f"rank{rank}")
    os.makedirs(outputs, exist_ok=True)
    device = default_device()

    def scan() -> tuple:
        out = tempfile.mkdtemp(prefix="scan.", dir=outputs)
        try:
            return summary(run_pipeline(scan_options([*argv, "--output-dir", out])))
        finally:
            shutil.rmtree(out, ignore_errors=True)

    scan()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    scans = []
    while go(ctrl, False):
        scans.append(scan())
    reports(ctrl, {"rank": rank, "scans": scans, "forbidden": forbidden_modules(),
                   "peak": torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0})
    return 0
