"""Command-line interface of the port: ``python -m spydrpick_torch aln.fasta``.

Every flag of ``spydrpick_tpu/cli.py`` is accepted, with the same names,
defaults and meanings, except:

  * flags that tune the TPU engine and mean nothing on the GPU are
    accepted and ignored, with one verbose line naming those that were set
    (``IGNORED``);
  * ``--edge-capacity`` is accepted and unused: there is no per-row edge
    window; ``--store-capacity`` is the initial size of the sweep's device
    edge store, which grows when a sweep finds more edges;
  * ``--profile-dir`` writes a torch.profiler trace of the whole scan,
    with the program's spans and counters beside it;
  * ``--checkpoint`` snapshots are the reference's format, written
    uncompressed, but one written by the JAX engine does not resume here
    (its sample axis is padded, so its key differs) and the sweep starts
    afresh; in a run of several processes every process reads the
    snapshot and only process 0 writes and deletes it, and a ``--sharded``
    snapshot without sample shards resumes in one process and the other
    way round (parallel/mesh.py: ``checkpoint_key``);
  * several processes run one analysis under ``torchrun`` or with the
    multi-host flags (``--coordinator-address``, ``--num-processes``,
    ``--process-id``, a tcp:// rendezvous; parallel/distributed.py, which
    also names the backend rule); ``--sharded`` then sweeps over them and
    ``--sample-shards k`` shards the samples k ways, which k must divide
    the process count for; every process ends with the same results and
    only process 0 writes files;
  * the run needs a GPU unless ``SPYDRPICK_TORCH_DEVICE=cpu`` asks for the
    CPU (``device.py``): without either it exits 1 before writing anything;
  * ``--row-window`` and ``--onehot-storage`` run as in the reference and
    change no output byte: ``--row-window W`` sweeps each block-row as
    j-windows of W columns (rounded to tiles as the reference rounds
    them), one K1 (or B3) and one B2 launch each; ``--onehot-storage
    codes`` keeps the uint8 codes and their K-major copy on the device (2
    bytes per sample and column, against 6 with the int8 modes' dense
    one-hot, 11 with bf16's) and expands each item's operands into one
    window's buffer on use.  "auto" (both flags' default) keeps dense
    full-width rows on a card while they fit in half of its memory, since
    there codes storage swept 6-7% slower than dense full-width rows and
    dense j-windows no faster (an H100 80GB HBM3 at 700 W, S=256 x
    L=262,144); otherwise, and on the CPU, it is the reference's rule:
    windows of 2^16 columns past 2^17 padded columns, codes storage past
    1 GiB of dense one-hot (engine/solver.py: ``build_device_data``).  The
    S=3000 x L=30720 bench alignment stays dense and full width either way.
"""

from __future__ import annotations

import argparse
import os
import sys

from spydrpick_torch.device import default_device
from spydrpick_torch.engine.aracne import DEFAULT_EDGE_THRESHOLD
from spydrpick_torch.parallel.distributed import initialize_distributed, shutdown
from spydrpick_torch.pipeline import PipelineOptions, run_pipeline
from spydrpick_torch.version import TITLE, version_string

# flag dest -> default, for the TPU engine's knobs this engine ignores
IGNORED = {
    "use_pallas": "auto",
    "use_pallas_compact": "auto",
    "rows_per_dispatch": 8,
    "pipeline_depth": 2,
    "matmul_precision": "high",
    "jax_cache_dir": None,
    "edge_capacity": 1 << 19,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spydrpick-torch",
        description=TITLE,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("alignmentfile", nargs="?", help="input FASTA alignment")
    p.add_argument("--version", action="store_true", help="print version information")
    p.add_argument("-v", "--verbose", action="store_true", help="be verbose")
    p.add_argument("-t", "--threads", type=int, default=-1,
                   help="host threads for the native (OpenMP) FASTA parser and, "
                        "on the CPU, ARACNE; -1 = all hardware threads")

    g = p.add_argument_group("MI options")
    g.add_argument("--mi-threshold", type=float, default=-1.0,
                   help="MI save threshold (0=no threshold; -1=determine automatically)")
    g.add_argument("--mi-values", type=int, default=0,
                   help="approximate number of MI values to save (0=min(1e7, 100*n_loci))")
    g.add_argument("--mi-pseudocount", type=float, default=0.5, help="MI pseudocount value")
    g.add_argument("--mi-threshold-iterations", type=int, default=10,
                   help="iterations for estimating the save threshold")
    g.add_argument("--mi-threshold-pairs", type=int, default=0,
                   help="sampled pairs per iteration (0=auto)")
    g.add_argument("--ld-threshold", type=int, default=0,
                   help="linkage-disequilibrium distance threshold")
    g.add_argument("--no-aracne", action="store_true", help="skip ARACNE, only calculate MI")

    g = p.add_argument_group("alignment options (apegrunt group in the reference)")
    g.add_argument("--maf-threshold", type=float, default=0.01,
                   help="minor-allele frequency filter threshold")
    g.add_argument("--gap-threshold", type=float, default=0.15,
                   help="gap frequency filter threshold")
    g.add_argument("--no-filter-alignment", action="store_true",
                   help="do not apply position filters")
    g.add_argument("--include-list", help="file of position indices to include")
    g.add_argument("--exclude-list", help="file of position indices to exclude")
    g.add_argument("--sample-list", help="file of sample indices to include")
    g.add_argument("--mappings-list", help="file of original position indices per column")
    g.add_argument("--genome-size", type=int, help="genome size for circular distance")
    g.add_argument("--input-indexing-base", type=int, default=1)
    g.add_argument("--output-indexing-base", type=int, default=1)
    g.add_argument("--linear-genome", action="store_true",
                   help="treat the genome as linear (default: circular)")
    g.add_argument("--sample-reweighting-threshold", type=float, default=0.9,
                   help="sequence identity threshold for sample clustering")
    g.add_argument("--no-sample-reweighting", action="store_true",
                   help="all samples get weight 1")
    g.add_argument("--sample-weights", help="file of user-supplied sample weights")
    g.add_argument("--output-state-frequencies", action="store_true")
    g.add_argument("--output-sample-weights", action="store_true")
    g.add_argument("--output-sample-distance-matrix", action="store_true")
    g.add_argument("--output-alignment", action="store_true")
    g.add_argument("--output-filtered-alignment", action="store_true")

    g = p.add_argument_group("ARACNE options")
    g.add_argument("--aracne-edge-threshold", type=float, default=DEFAULT_EDGE_THRESHOLD,
                   help="equality tolerance for the DPI rule")
    g.add_argument("--aracne-block-size", type=int, default=16384,
                   help="accepted for compatibility (closed-form kernel needs no blocking)")
    g.add_argument("--aracne-node-grouping-size", type=int, default=16,
                   help="accepted for compatibility")
    g.add_argument("--aracne-outputfile", default="aracne.out",
                   help="accepted for compatibility (unused, as in the reference)")

    g = p.add_argument_group("engine options")
    g.add_argument("--seed", type=int, default=42,
                   help="PRNG seed for threshold-pair sampling")
    g.add_argument("--tile", type=int, default=512,
                   help="columns per sweep block-row (a multiple of 128)")
    g.add_argument("--edge-capacity", type=int, default=1 << 19,
                   help="accepted, unused: the sweep has no per-row edge window")
    g.add_argument("--store-capacity", type=int, default=1 << 24,
                   help="initial edges of the sweep's device edge store; it grows when a "
                        "sweep finds more")
    g.add_argument("--onehot-storage", choices=["auto", "dense", "codes"], default="auto",
                   help="alignment residency on the device: dense = the K-major one-hot, "
                        "codes = uint8 codes expanded per sweep item; auto = dense while dense "
                        "full-width rows fit in half of the GPU, else codes past 1 GiB of "
                        "dense one-hot")
    g.add_argument("--rows-per-dispatch", type=int, default=8,
                   help="TPU engine option, ignored here")
    g.add_argument("--pipeline-depth", type=int, default=2,
                   help="TPU engine option, ignored here")
    g.add_argument("--row-window", type=int, default=0,
                   help="j-window width of a sweep item (rounded to tiles); 0 = auto (full "
                        "width while dense full-width rows fit in half of the GPU, else 65536 "
                        "past 131072 padded columns), 1 = full-width rows")
    g.add_argument("--use-pallas", choices=["auto", "on", "off"], default="auto",
                   help="TPU engine option, ignored here (the CUDA kernels always run on a GPU)")
    g.add_argument("--use-pallas-compact", choices=["auto", "on", "off"], default="auto",
                   help="TPU engine option, ignored here")
    g.add_argument("--mxu-int8", choices=["auto", "on", "off"], default="auto",
                   help="int8 crosstable operands: auto = exact for unit weights, "
                        "fixed-point for weight spreads <= 32; on = fixed point for any "
                        "positive weights; off = bf16 hi/lo split")
    g.add_argument("--matmul-precision", choices=["highest", "high", "default"],
                   default="high", help="TPU engine option, ignored here")
    g.add_argument("--output-dir", default=".", help="directory for output files")
    g.add_argument("--checkpoint", help="sweep checkpoint file: resume a killed run")
    g.add_argument("--checkpoint-every", type=int, default=16,
                   help="checkpoint every N block-rows")
    g.add_argument("--profile-dir",
                   help="write a torch.profiler trace of the whole scan here "
                        "(scan_trace.json, scan_kernels.txt) with the program's spans and "
                        "counters (scan_spans.json)")
    g.add_argument("--jax-cache-dir", default=None, help="TPU engine option, ignored here")
    g.add_argument("--sharded", action="store_true",
                   help="shard the sweep over every process of the run (torchrun or the "
                        "multi-host flags)")
    g.add_argument("--sample-shards", type=int, default=1,
                   help="with --sharded: shard the alignment's samples over this many "
                        "processes (2-D rows x samples mesh)")

    g = p.add_argument_group("multi-host options (a tcp:// rendezvous, one device each)")
    g.add_argument("--coordinator-address", help="host:port of process 0")
    g.add_argument("--num-processes", type=int, help="total process count")
    g.add_argument("--process-id", type=int, help="this process's id")
    return p


def _world_size(args) -> int:
    """Processes in the run, from the multi-host flags or torchrun's
    environment."""
    if args.num_processes is not None:
        return args.num_processes
    return int(os.environ.get("WORLD_SIZE", "1"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(version_string())
        return 0
    if not args.alignmentfile:
        print("spydrpick-torch ERROR: No alignment file specified!", file=sys.stderr)
        return 1
    world = _world_size(args)
    if args.sample_shards < 1 or (args.sharded and world > 1 and world % args.sample_shards):
        print(f"spydrpick-torch ERROR: --sample-shards {args.sample_shards} does not divide "
              f"the {world} processes of the run", file=sys.stderr)
        return 1
    try:
        default_device()  # no GPU and no SPYDRPICK_TORCH_DEVICE=cpu: refuse before any output
        initialize_distributed(args.coordinator_address, args.num_processes, args.process_id)
    except (RuntimeError, ValueError) as e:
        print(f"spydrpick-torch ERROR: {e}", file=sys.stderr)
        return 1
    try:
        return _run(args)
    finally:
        shutdown()


def _run(args) -> int:
    print(version_string())
    ignored = [k for k, default in IGNORED.items() if getattr(args, k) != default]
    if args.verbose and ignored:
        print("spydrpick-torch: ignored on this engine: "
              + ", ".join("--" + k.replace("_", "-") for k in ignored), flush=True)
    if args.threads and args.threads > 0:
        os.environ["OMP_NUM_THREADS"] = str(args.threads)
    opts = PipelineOptions(
        alignmentfile=args.alignmentfile,
        mi_threshold=args.mi_threshold,
        mi_values=args.mi_values,
        mi_pseudocount=args.mi_pseudocount,
        mi_threshold_iterations=args.mi_threshold_iterations,
        mi_threshold_pairs=args.mi_threshold_pairs,
        ld_threshold=args.ld_threshold,
        no_aracne=args.no_aracne,
        verbose=args.verbose,
        maf_threshold=args.maf_threshold,
        gap_threshold=args.gap_threshold,
        no_filter_alignment=args.no_filter_alignment,
        include_list=args.include_list,
        exclude_list=args.exclude_list,
        sample_list=args.sample_list,
        mappings_list=args.mappings_list,
        genome_size=args.genome_size,
        input_indexing_base=args.input_indexing_base,
        output_indexing_base=args.output_indexing_base,
        linear_genome=args.linear_genome,
        sample_reweighting_threshold=args.sample_reweighting_threshold,
        no_sample_reweighting=args.no_sample_reweighting,
        sample_weights=args.sample_weights,
        output_state_frequencies=args.output_state_frequencies,
        output_sample_weights=args.output_sample_weights,
        output_sample_distance_matrix=args.output_sample_distance_matrix,
        output_alignment=args.output_alignment,
        output_filtered_alignment=args.output_filtered_alignment,
        aracne_edge_threshold=args.aracne_edge_threshold,
        seed=args.seed,
        tile=args.tile,
        mxu_int8=args.mxu_int8,
        store_capacity=args.store_capacity,
        onehot_storage=args.onehot_storage,
        row_window=args.row_window,
        output_dir=args.output_dir,
        profile_dir=args.profile_dir,
        checkpoint=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        sharded=args.sharded,
        sample_shards=args.sample_shards,
    )
    try:
        run_pipeline(opts)
    except (FileNotFoundError, ValueError) as e:
        print(f"spydrpick-torch ERROR: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
