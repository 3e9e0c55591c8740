"""End-to-end GWES pipeline on PyTorch (port of spydrpick_tpu/pipeline.py).

Stages: load -> include/exclude trim -> position filter -> sample trim ->
sample weights -> MI save threshold (auto: tournament) -> all-pairs MI
sweep -> Tukey outlier thresholds -> sort -> ARACNE -> couplings/outlier
outputs.  Host stages run the port's own copies of the reference's host
modules (``core``, ``io``, ``native``, ``utils``); the device stages run on
``spydrpick_torch.device.default_device()``.  On a card the sorted edges
stay there: ARACNE's flags (``ops/aracne.py``) and the couplings file's
bytes (``ops/format.py``) are computed by CUDA kernels, and the host
receives the flags and the finished bytes.  On the CPU those two stages
run the native host copies (``engine/aracne.py:run_aracne``,
``io/writers.py:write_couplings``), which are many times faster there
than the kernels' plain versions (PERF.md §6).  The outliers file and the
outlier-node FASTA are written on the host from the host EdgeSet.

In a run of several processes (``parallel/distributed.py``) every rank
runs every stage and ends with the same results; only rank 0 writes
files.  ``sharded`` sweeps the block-rows over the ranks and, with
``sample_shards`` > 1, shards the samples too (``parallel/mesh.py``); the
tournament and the lazy wo-gaps resolve then run on the sample shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.core.filter import FilterParams, filter_list
from spydrpick_torch.io.fasta import read_fasta, write_fasta
from spydrpick_torch.io.loci import parse_loci_list
from spydrpick_torch.io.writers import (
    write_couplings,
    write_couplings_rows,
    write_distance_matrix,
    write_outliers,
    write_sample_weights,
    write_state_frequencies,
)
from spydrpick_torch.core.weights import (
    DEFAULT_REWEIGHTING_THRESHOLD,
    cache_sample_weights,
    hamming_distance_matrix,
)
from spydrpick_torch.device import default_device, synchronize, to_host
from spydrpick_torch.engine.aracne import DEFAULT_EDGE_THRESHOLD, run_aracne
from spydrpick_torch.engine.outliers import outlier_thresholds
from spydrpick_torch.engine.solver import DeviceEdges, EdgeSet, EngineConfig, MIEngine
from spydrpick_torch.engine.threshold import default_mi_values, determine_mi_threshold
from spydrpick_torch.ops.aracne import aracne_flags
from spydrpick_torch.ops.columns import column_state_counts
from spydrpick_torch.ops.compact import row_select
from spydrpick_torch.ops.format import format_couplings_rows
from spydrpick_torch.ops.mi_kernels import crosstab_tile, mi_epilogue, mi_tile_dual, mi_tile_single
from spydrpick_torch.ops.pairs import pairs_xtab
from spydrpick_torch.parallel.distributed import is_writer, world_size
from spydrpick_torch.utils.profiling import (
    SCAN,
    count,
    profile_trace,
    recording,
    seconds,
    span,
    summary,
)
from spydrpick_torch.utils.stopwatch import time_string
from spydrpick_torch.utils.uniquefile import unique_path


@dataclasses.dataclass
class PipelineOptions:
    """The reference's three flag groups (SpydrPick / apegrunt / ARACNE)
    plus --seed and the engine options this port runs."""

    alignmentfile: str = ""
    mi_threshold: float = -1.0
    mi_values: int = 0
    mi_pseudocount: float = 0.5
    mi_threshold_iterations: int = 10
    mi_threshold_pairs: int = 0
    ld_threshold: int = 0
    no_aracne: bool = False
    verbose: bool = False
    maf_threshold: float = 0.01
    gap_threshold: float = 0.15
    no_filter_alignment: bool = False
    include_list: str | None = None
    exclude_list: str | None = None
    sample_list: str | None = None
    mappings_list: str | None = None
    genome_size: int | None = None
    input_indexing_base: int = 1
    output_indexing_base: int = 1
    linear_genome: bool = False
    sample_reweighting_threshold: float = DEFAULT_REWEIGHTING_THRESHOLD
    no_sample_reweighting: bool = False
    sample_weights: str | None = None
    output_state_frequencies: bool = False
    output_sample_weights: bool = False
    output_sample_distance_matrix: bool = False
    output_alignment: bool = False
    output_filtered_alignment: bool = False
    aracne_edge_threshold: float = DEFAULT_EDGE_THRESHOLD
    seed: int = 42
    tile: int = 512
    mxu_int8: str = "auto"
    store_capacity: int = 1 << 24       # initial slots of the sweep's device edge store
    onehot_storage: str = "auto"        # "auto" | "dense" | "codes" (EngineConfig)
    row_window: int = 0                 # j-window width: 0 auto, 1 full-width rows
    output_dir: str = "."
    profile_dir: str | None = None      # torch.profiler trace of the whole scan
    checkpoint: str | None = None       # sweep checkpoint file (resume support)
    checkpoint_every: int = 16
    sharded: bool = False               # sweep over every process of the run
    sample_shards: int = 1              # with sharded: shard the samples this many ways


@dataclasses.dataclass
class PipelineResult:
    alignment: Alignment
    edges: EdgeSet
    flags: np.ndarray
    mi_threshold: float
    outlier_threshold: float
    extreme_outlier_threshold: float
    couplings_path: str | None = None
    outliers_path: str | None = None


def _log(opts, *msg):
    if opts.verbose:
        print("spydrpick-torch:", *msg, file=sys.stdout, flush=True)


def load_and_preprocess(opts: PipelineOptions) -> Alignment:
    """Load, trim, filter and weight the alignment (SpydrPick.cpp:163-333);
    the same steps as the reference's load_and_preprocess.  On a card the
    parser decodes into pinned memory and the codes go to the card once,
    right after the parse (``Alignment.device_codes``): the lists' and the
    filter's subsets, the filter's counts (``ops/columns.py``) and the
    computed weights read that copy, and so does the engine
    (``build_device_data``).  On the CPU the host codes are the only
    codes.  Each part is a span: parse (the FASTA and the mappings list; in
    it the native parser's read, alloc and decode), upload (the codes' copy
    to the card; none on the CPU), lists (include, exclude and sample
    lists, and their subsets), filter (the counts, the filter rules and
    their subset), weights and outputs (the optional side files).  The
    counters columns_in and columns_kept count the filter's columns."""
    device = default_device()
    with span("parse"):
        mappings = (
            parse_loci_list(opts.mappings_list, opts.input_indexing_base)
            if opts.mappings_list
            else None
        )
        alignment = read_fasta(opts.alignmentfile, mappings=mappings,
                               genome_size=opts.genome_size, pinned=device.type == "cuda")
        _log(opts, f'alignment "{alignment.id_string}": '
             f"{alignment.n_samples} samples x {alignment.n_loci} loci")
    if device.type == "cuda":
        with span("upload"):
            alignment.device_codes = torch.from_numpy(alignment.codes).to(
                device, non_blocking=True)
            synchronize(device)

    with span("outputs"):
        if opts.output_alignment and is_writer():
            write_fasta(unique_path(f"{opts.output_dir}/{alignment.id_string}.input.fasta"),
                        alignment)

    with span("lists"):
        if opts.include_list:
            incl = set(parse_loci_list(opts.include_list, opts.input_indexing_base).tolist())
            keep = np.array(
                [k for k, t in enumerate(alignment.translation) if t in incl],
                dtype=np.int64)
            alignment = alignment.subset(keep)
            _log(opts, f"include list -> {alignment.n_loci} loci")
        if opts.exclude_list:
            excl = set(parse_loci_list(opts.exclude_list, opts.input_indexing_base).tolist())
            keep = np.array(
                [k for k, t in enumerate(alignment.translation) if t not in excl],
                dtype=np.int64)
            alignment = alignment.subset(keep)
            _log(opts, f"exclude list -> {alignment.n_loci} loci")

    with span("filter"):
        count("columns_in", alignment.n_loci)
        if not opts.no_filter_alignment:
            keep = filter_list(alignment, FilterParams(opts.maf_threshold, opts.gap_threshold))
            _log(opts, f"apply filter rules.. {len(keep)} positions fulfill filter criteria")
            if len(keep) == 0:
                _log(opts, "nothing to do")
                raise SystemExit(0)
            if len(keep) != alignment.n_loci:
                alignment = alignment.subset(keep)
            if opts.verbose:
                print(alignment.statistics_string(), flush=True)
        count("columns_kept", alignment.n_loci)

    with span("lists"):
        if opts.sample_list:
            alignment = alignment.subsample(
                parse_loci_list(opts.sample_list, opts.input_indexing_base))
            _log(opts, f"sample list -> {alignment.n_samples} samples")

    with span("weights"):
        alignment = cache_sample_weights(
            alignment,
            weights_file=opts.sample_weights,
            no_reweighting=opts.no_sample_reweighting,
            threshold=opts.sample_reweighting_threshold,
            device=device,
        )
        _log(opts, f"effective sample size = {alignment.effective_size:.2f}")

    with span("outputs"):
        _side_files(opts, alignment, device)
    return alignment


def _side_files(opts: PipelineOptions, alignment: Alignment, device) -> None:
    """The optional files of the weighted, filtered alignment."""
    if opts.output_sample_weights and is_writer():
        with open(unique_path(f"{opts.output_dir}/{alignment.id_string}.weights"), "w") as f:
            write_sample_weights(f, alignment)
    if opts.output_filtered_alignment and is_writer():
        write_fasta(unique_path(f"{opts.output_dir}/{alignment.id_string}.filtered.fasta"),
                    alignment)
    if opts.output_state_frequencies and is_writer():
        with open(
            unique_path(f"{opts.output_dir}/{alignment.id_string}.state_frequencies"), "w"
        ) as f:
            write_state_frequencies(f, alignment, opts.output_indexing_base)
    if opts.output_sample_distance_matrix and is_writer():
        with open(
            unique_path(f"{opts.output_dir}/{alignment.id_string}.distance_matrix"), "w"
        ) as f:
            write_distance_matrix(f, hamming_distance_matrix(alignment, device=device))


def engine_config(opts: PipelineOptions) -> EngineConfig:
    """The sweep engine's configuration for these options.  The pipeline
    resolves wo-gaps MI lazily, for outlier candidates only (the only
    edges whose wog the outputs read), checkpointed runs included, as the
    reference's pipeline does (pipeline.py:236-243)."""
    return EngineConfig(
        tile=opts.tile,
        mxu_int8=opts.mxu_int8,
        pseudocount=opts.mi_pseudocount,
        ld_threshold=opts.ld_threshold,
        linear_genome=opts.linear_genome,
        wog_fetch="outliers",
        store_capacity=opts.store_capacity,
        onehot_storage=opts.onehot_storage,
        row_window=opts.row_window,
    )


# the stage keys of run_pipeline's timings and the spans they are views of
STAGES = (("preprocess_s", "lead_in"), ("engine_build_s", "engine_build"),
          ("threshold_s", "tournament"), ("sweep_s", "sweep"), ("sort_s", "sort"),
          ("aracne_s", "aracne"), ("write_s", "write"), ("total_s", SCAN))


def run_pipeline(opts: PipelineOptions, write_outputs: bool = True,
                 timings: dict | None = None) -> PipelineResult:
    """One scan.  With ``timings`` (a dict), or with ``opts.verbose`` or
    ``opts.profile_dir``, the scan is recorded (``utils/profiling.py``):
    ``timings`` receives the spans, the counters and the scan's number
    ("spans", "counters", "scan"), and per stage the seconds of its span
    (``STAGES``: preprocess_s ... write_s, and total_s, the span scan, the
    whole call).  Each stage's span ends after a wait for the device, so a
    stage's time includes its device work.  The counters
    launches.<wrapper> hold the scan's kernel launches of each wrapper
    (``kernel_launches``, read at the scan's start and end).
    ``opts.profile_dir`` traces the whole call (``profile_trace``).
    Without any of the three nothing is recorded."""
    record = timings
    if record is None and (opts.verbose or opts.profile_dir):
        record = {}
    with profile_trace(opts.profile_dir if is_writer() else None, record), recording(record):
        before = kernel_launches()
        result = _scan(opts, write_outputs, record)
        for name, n in kernel_launches().items():
            count(f"launches.{name}", n - before[name])
    if record is not None:
        for key, path in STAGES:
            if any(sp["path"] == path for sp in record["spans"]):
                record[key] = seconds(record["spans"], path)
        _log(opts, "counters: " + ", ".join(f"{k} {v}" for k, v in record["counters"].items()))
        _log(opts, "spans: " + ", ".join(f"{path} {p['seconds']:.4f}s"
                                         for path, p in summary(record["spans"]).items()))
        _log(opts, f"analysis completed in {time_string(record['total_s'])}")
    return result


def kernel_launches() -> dict:
    """Each CUDA kernel wrapper's launches so far (its ``launches``
    attribute; calls on the CPU run the plain version and do not count),
    by the wrapper's name, and K1's launches on its wgmma loop
    (``mi_tile_single_wgmma``)."""
    counts = {fn.__name__: fn.launches
              for fn in (mi_tile_single, mi_tile_dual, crosstab_tile, mi_epilogue, row_select,
                         aracne_flags, format_couplings_rows, column_state_counts, pairs_xtab)}
    counts["mi_tile_single_wgmma"] = mi_tile_single.launches_wgmma
    return counts


def _scan(opts: PipelineOptions, write_outputs: bool, record: dict | None) -> PipelineResult:
    """``run_pipeline``'s stages, each in its span; ``record`` is the
    scan's recording (None when the scan is not recorded)."""
    device = default_device()
    if is_writer():
        os.makedirs(opts.output_dir, exist_ok=True)

    @contextlib.contextmanager
    def stage(name: str):
        with span(name) as sp:
            yield
            synchronize(device)
        if sp is not None:
            _log(opts, f"stage time: {name} {sp.seconds:.2f}s")

    with stage("lead_in"):
        alignment = load_and_preprocess(opts)

    # sharded runs build the mesh before the tournament, so that with
    # sample shards the tournament runs on them too (pipeline.py:248-269)
    with stage("engine_build"):
        mesh = None
        if opts.sharded and world_size() > 1:
            from spydrpick_torch.parallel.mesh import ShardedEngineView, make_mesh

            mesh = make_mesh(opts.sample_shards)
        elif opts.sharded:
            _log(opts, "only one device visible; using single-device sweep")
        if mesh is not None and opts.sample_shards > 1:
            engine = ShardedEngineView(alignment, engine_config(opts), mesh, device)
        else:
            engine = MIEngine(alignment, engine_config(opts), device=device)
        st = engine.statics
        _log(opts, f"engine on {device}: int8 mode {st.int8_mode}, "
             f"{engine.S} sample rows x {engine.Lp} columns, "
             f"{'codes' if st.onehot_codes else 'dense'} one-hot, "
             + (f"j-windows of {st.row_window} columns" if st.row_window else "full-width rows")
             + (f", mesh rows x samples = {tuple(mesh.shape)}" if mesh is not None else ""))

    with stage("tournament"):
        mi_threshold = opts.mi_threshold
        if mi_threshold < 0:
            top_pairs = default_mi_values(alignment.n_loci, opts.mi_values)
            _log(opts, f"determine MI threshold for saving approx. {top_pairs} top pairs")
            mi_threshold = determine_mi_threshold(
                engine, top_pairs,
                threshold_pairs=opts.mi_threshold_pairs,
                iterations=opts.mi_threshold_iterations,
                seed=opts.seed,
                verbose_out=sys.stdout if opts.verbose else None,
            )
            _log(opts, f"MI save threshold = {mi_threshold:.6f}")
        else:
            _log(opts, f"user-defined MI save threshold = {mi_threshold:.6f}")

    def progress(lo, hi, n_new, dt):
        _log(opts, f"  {lo + 1}-{hi} / {alignment.n_loci} ({n_new} new edges) time={dt:.3f}s")

    with stage("sweep"):
        if mesh is not None:
            from spydrpick_torch.parallel.mesh import sharded_sweep

            edges = sharded_sweep(engine, mi_threshold, mesh,
                                  progress=progress if opts.verbose else None,
                                  checkpoint_path=opts.checkpoint,
                                  checkpoint_every=opts.checkpoint_every)
        else:
            edges = engine.sweep(mi_threshold, progress=progress if opts.verbose else None,
                                 checkpoint_path=opts.checkpoint,
                                 checkpoint_every=opts.checkpoint_every)
    if opts.checkpoint and record is not None:
        _log(opts, f"checkpoint saves: {seconds(record['spans'], 'sweep.rows.save'):.2f}s")
    _log(opts, f"{edges.n_edges} edges stored")

    outlier_thr, extreme_thr = outlier_thresholds(edges.colmax)
    _log(opts, f"outlier threshold={outlier_thr:.6f}")
    _log(opts, f"extreme outlier threshold={extreme_thr:.6f}")

    # sort_desc's order from one device sort; on a card the sorted columns
    # stay there for ARACNE and the couplings file, while the CPU runs the
    # native host copies (the plain versions are far slower there)
    with stage("sort"):
        edges, dev_edges = edges.sorted_on(device)
        if not dev_edges.mi.is_cuda:
            dev_edges = None

    with stage("aracne"):
        flags, dev_flags = np.zeros(edges.n_edges, dtype=np.uint8), None
        if not opts.no_aracne and edges.n_edges:
            _log(opts, "run ARACNE")
            if dev_edges is not None:
                dev_flags = aracne_flags(dev_edges.ipos, dev_edges.jpos, dev_edges.mi,
                                         opts.aracne_edge_threshold)
                flags = to_host([dev_flags])[0]
            else:
                flags = run_aracne(edges.ipos, edges.jpos, edges.mi, opts.aracne_edge_threshold)
        elif dev_edges is not None:
            dev_flags = torch.zeros(edges.n_edges, dtype=torch.uint8, device=device)

    result = PipelineResult(
        alignment=alignment,
        edges=edges,
        flags=flags,
        mi_threshold=mi_threshold,
        outlier_threshold=outlier_thr,
        extreme_outlier_threshold=extreme_thr,
    )
    if write_outputs and is_writer():
        with stage("write"):
            _write_outputs(opts, result, dev_edges, dev_flags)
    return result


def _write_outputs(opts: PipelineOptions, res: PipelineResult, dev_edges: DeviceEdges | None,
                   dev_flags) -> None:
    """Couplings + outliers + outlier-node FASTA (SpydrPick.cpp:423-510),
    each in its span (couplings, outliers, nodes).  With ``dev_edges`` (a
    card) the couplings rows are formatted there (``write_couplings_rows``,
    its spans format, copy and file inside couplings); else, and for the
    other files, on the host.  The counters bytes_written.couplings,
    .outliers and .nodes count the bytes each writer handed its file."""
    al = res.alignment
    base = opts.output_indexing_base
    stem = f"{opts.output_dir}/{al.id_string}.{al.size_string()}.spydrpick_couplings"
    with span("couplings"):
        couplings_path = unique_path(f"{stem}.{base}-based.{res.edges.n_edges}edges")
        if dev_edges is not None:
            with open(couplings_path, "wb") as f:
                write_couplings_rows(f, dev_edges.ipos, dev_edges.jpos, dev_edges.mi,
                                     dev_flags, al, base, opts.linear_genome)
        else:
            with open(couplings_path, "w") as f:
                write_couplings(f, res.edges, res.flags, al, base, opts.linear_genome)
        res.couplings_path = str(couplings_path)
        _log(opts, f'wrote network ({res.edges.n_edges} edges) to "{couplings_path}"')

    with span("outliers"):
        outliers_path = unique_path(f"{stem}.{base}-based.outliers")
        with open(outliers_path, "w") as f:
            n_rows = write_outliers(
                f, res.edges, res.flags, al,
                res.outlier_threshold, res.extreme_outlier_threshold,
                opts.ld_threshold, base, opts.linear_genome,
            )
        res.outliers_path = str(outliers_path)
        _log(opts, f'wrote outlier network ({n_rows} rows) to "{outliers_path}"')

    with span("nodes"):
        mask = res.edges.mi >= res.outlier_threshold
        nodes = np.unique(np.concatenate([res.edges.ipos[mask], res.edges.jpos[mask]]))
        _log(opts, f"extract nodes involved in outlier edges: found {len(nodes)} nodes")
        n_bytes = 0
        if 0 < len(nodes) < al.n_loci:
            n_bytes = write_fasta(
                unique_path(f"{opts.output_dir}/{al.id_string}.outlier_nodes.fasta"),
                al.subset(nodes))
        count("bytes_written.nodes", n_bytes)
