"""The port's wide-alignment path on the CPU: j-windowed block-rows
(``EngineConfig.row_window``, ``--row-window``) and codes-resident storage
(``onehot_storage="codes"``, ``--onehot-storage codes``) in
spydrpick_torch/engine/solver.py, with B2's j0 (ops/compact.py).

Neither option changes a value, so the windowed and codes sweeps are held
to the port's own full-width dense sweep bit for bit (edges in sweep
order, mi, wog, colmax) in the unit, fixed14 and bf16 modes, lazy and
exact wog; against the JAX package's windowed codes engine (run as
tests/test_engine.py:350-428 runs it, on its XLA path) they agree within
the port's parity bound.  Also: the window resolution against the
reference's, the codes expansion against ``k_major`` of the one-hot,
``row_select_plain`` on windows against the full-width row, a windowed
kill-and-resume, the CLI with both flags and the rows- and sample-
sharded gloo runs with windows.  Port tile 128, L 700-1300, S 45-120.
"""

import dataclasses
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from spydrpick_tpu.engine.solver import EngineConfig as JaxConfig
from spydrpick_tpu.engine.solver import MIEngine as JaxEngine
from spydrpick_tpu.engine.solver import build_device_data as jax_build_device_data
from spydrpick_tpu.io.fasta import write_fasta
from spydrpick_torch.cli import main as torch_main
from spydrpick_torch.engine import checkpoint as ck
from spydrpick_torch.engine import solver
from spydrpick_torch.engine.solver import (
    EngineConfig,
    MIEngine,
    build_device_data,
    codes_k_major,
    device_data_from_jax,
    expand_codes,
    resolve_row_window,
)
from spydrpick_torch.ops.compact import EdgeStore, row_select_plain
from spydrpick_torch.ops.mi_kernels import k_major
from spydrpick_torch.utils.profiling import recording

from tests.conftest import random_alignment
from tests.test_torch_checkpoint import Killed, killer
from tests.test_torch_engine import assert_sweeps_agree
from tests.test_torch_sharding import free_port, spawn

TILE = 128
FIELDS = ("ipos", "jpos", "mi", "mi_wog", "colmax")
# mode -> (mxu_int8, unit weights)
MODES = {"unit": ("auto", True), "fixed14": ("auto", False), "bf16": ("off", False)}
WOGS = ("outliers", "full")
# variant -> the options it adds to the full-width dense engine
VARIANTS = {
    "dense_window256": dict(onehot_storage="dense", row_window=256),
    "codes_window384": dict(onehot_storage="codes", row_window=384),
    "codes_full_width": dict(onehot_storage="codes", row_window=1),
}


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    """The CLI runs here ask for the CPU (spydrpick_torch/device.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        yield


def mode_alignment(mode, n_samples=61, n_loci=900, seed=71):
    mxu_int8, unit = MODES[mode]
    al = random_alignment(n_samples=n_samples, n_loci=n_loci, seed=seed, gap_frac=0.12)
    al.codes[:, n_loci - 100] = al.codes[:, 30]  # a planted outlier coupling
    if unit:
        al.weights = None
    return al, mxu_int8


def top_threshold(engine, keep=0.03):
    """A threshold keeping about ``keep`` of the pairs."""
    rng = np.random.default_rng(0)
    ii, jj = rng.integers(0, engine.L, (2, 4000))
    ok = ii < jj
    return float(np.quantile(engine.pair_mi(ii[ok], jj[ok]), 1 - keep))


def assert_same_edges(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.fixture(scope="module")
def full_width():
    """(alignment, mxu_int8, threshold, full-width dense sweep) per (mode, wog)."""
    res = {}
    for mode in MODES:
        al, mxu = mode_alignment(mode)
        thr = None
        for wog in WOGS:
            eng = MIEngine(al, EngineConfig(tile=TILE, mxu_int8=mxu, wog_fetch=wog,
                                            onehot_storage="dense", row_window=1), device="cpu")
            assert eng.statics.row_window == 0 and not eng.statics.onehot_codes
            thr = top_threshold(eng) if thr is None else thr
            res[mode, wog] = (al, mxu, thr, eng.sweep(thr))
    return res


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("wog", WOGS)
@pytest.mark.parametrize("mode", list(MODES))
def test_windowed_and_codes_sweeps_equal_the_full_width_sweep(full_width, mode, wog, variant,
                                                              monkeypatch):
    al, mxu, thr, want = full_width[mode, wog]
    eng = MIEngine(al, EngineConfig(tile=TILE, mxu_int8=mxu, wog_fetch=wog, **VARIANTS[variant]),
                   device="cpu")
    st = eng.statics
    assert st.onehot_codes == (VARIANTS[variant]["onehot_storage"] == "codes")
    assert st.int8_mode == {"unit": "unit", "fixed14": "fixed14", "bf16": "off"}[mode]
    expansions = []
    expand_codes = solver.expand_codes

    def spy(*args, **kwargs):
        expansions.append(args[1:3])
        return expand_codes(*args, **kwargs)
    monkeypatch.setattr(solver, "expand_codes", spy)
    rec = {}
    with recording(rec):
        got = eng.sweep(thr)
    assert want.n_edges > 1000 and (got.mi_wog != got.mi).any()
    assert_same_edges(got, want)
    rows = range(0, st.L, TILE)
    n_items = rec["counters"]["sweep_items"]
    assert n_items == sum(len(eng.row_windows(r)) for r in rows)
    assert rec["counters"]["rows_reswept"] == 0
    # codes storage expands each item's operands on use; dense storage never
    assert bool(expansions) == st.onehot_codes
    if st.row_window:
        assert n_items > len(rows)


def test_row_windows_cover_each_row_from_its_diagonal():
    """A row's items tile [i0, Lp) in order: the diagonal window starts at
    i0 and windows wholly left of it are skipped."""
    al, _ = mode_alignment("fixed14")
    eng = MIEngine(al, EngineConfig(tile=TILE, row_window=384), device="cpu")
    rw, Lp = eng.statics.row_window, eng.statics.Lp
    assert (rw, Lp) == (384, 1152)
    assert eng.row_windows(0) == [(0, 384), (384, 384), (768, 384)]
    assert eng.row_windows(512) == [(512, 256), (768, 384)]
    assert eng.row_windows(768) == [(768, 384)]
    for i0 in range(0, eng.L, TILE):
        items = eng.row_windows(i0)
        assert items[0][0] == i0
        assert all(j0 + W == n0 for (j0, W), (n0, _) in zip(items, items[1:]))
        assert items[-1][0] + items[-1][1] == Lp
        assert all(W % TILE == 0 and 0 < W <= rw for _, W in items)


@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
def test_windowed_codes_sweep_matches_the_jax_windowed_codes_engine(mode):
    al, mxu = mode_alignment(mode, n_samples=48, n_loci=700, seed=72)
    cfg = dict(tile=TILE, row_window=256, onehot_storage="codes", wog_fetch="outliers")
    port = MIEngine(al, EngineConfig(mxu_int8=mxu, **cfg), device="cpu")
    ref = JaxEngine(al, JaxConfig(**cfg))
    assert ref.statics.onehot_codes and port.statics.onehot_codes
    assert (port.statics.row_window, port.statics.Lp) == (ref.statics.row_window, ref.statics.Lp)
    thr = top_threshold(port)
    a, b = port.sweep(thr).sort_desc(), ref.sweep(thr).sort_desc()
    assert assert_sweeps_agree(a, b, thr) > 0


def test_port_sweeps_the_jax_codes_engines_device_data():
    """``device_data_from_jax`` of a JAX engine in codes storage (its
    ``onehot`` is the codes): the port sweeps it to its own edges."""
    al, _ = mode_alignment("fixed14", n_samples=48, n_loci=700, seed=73)
    cfg = dict(tile=TILE, row_window=256, onehot_storage="codes", wog_fetch="outliers")
    ref = JaxEngine(al, JaxConfig(**cfg))
    port = MIEngine(al, EngineConfig(**cfg), device="cpu")
    data = device_data_from_jax(ref.data, torch.device("cpu"))
    assert data.onehot is None and data.codes.shape == port.data.codes.shape
    carried = MIEngine(al, port.config, device="cpu", _prebuilt=(data, port.statics))
    thr = top_threshold(port)
    assert_same_edges(carried.sweep(thr), port.sweep(thr))


def wide_columns(cols, S=256, L=998_400, rows=16):
    """Columns ``cols`` of scripts/bench_1m_width.py's S x L alignment and
    its weights: ``chip_smoke.bench_alignment(S, L, 0)``'s numbers,
    drawn ``rows`` samples at a time so that the whole alignment is never
    held."""
    rng = np.random.default_rng(0)
    parts = range(0, S, rows)
    codes = np.concatenate([rng.integers(0, 4, size=(min(rows, S - r), L)).astype(np.uint8)[:, cols]
                            for r in parts])
    gaps = np.concatenate([(rng.random((min(rows, S - r), L)) < 0.05)[:, cols] for r in parts])
    codes[gaps] = 4
    return codes, rng.random(S) * 0.9 + 0.1


def test_jax_kernel_and_port_agree_on_the_1m_alignments_pairs():
    """MI carries no shift between the port and the JAX package's sweep
    on the pairs of the 1M-column width alignment (scripts/
    bench_1m_width.py): 2048 of its columns, swept at its threshold less
    4e-5 by the JAX engine on its TPU path (the fused Pallas kernel, here
    interpreted, in fixed14, codes storage, tile 512) and by the port.
    The edges agree apart from the band, MI within TOL, and the mean
    difference is below 1e-6 (a 2.5e-5 shift moves that alignment's
    count by about 0.46%)."""
    from spydrpick_torch.core.alignment import Alignment as TorchAlignment
    from spydrpick_tpu.core.alignment import Alignment

    S, n, thr = 256, 2048, 0.084647 - 4e-5
    cols = np.sort(np.random.default_rng(123).choice(998_400, n, replace=False))
    codes, w = wide_columns(cols)
    names = [f"s{i}" for i in range(S)]
    cfg = dict(tile=512, row_window=1024, onehot_storage="codes", wog_fetch="outliers")
    ref = JaxEngine(Alignment(codes, names, "wide", np.arange(n), n, w),
                    JaxConfig(use_pallas="on", **cfg))
    port = MIEngine(TorchAlignment(codes, names, "wide", np.arange(n), n, w), EngineConfig(**cfg),
                    device="cpu")
    assert ref.statics.int8_mode == port.statics.int8_mode == "fixed14"
    a, b = port.sweep(thr).sort_desc(), ref.sweep(thr).sort_desc()
    assert_sweeps_agree(a, b, thr)
    ka, kb = a.ipos * n + a.jpos, b.ipos * n + b.jpos
    common, ia, ib = np.intersect1d(ka, kb, return_indices=True)
    assert len(common) > 300
    assert abs(float(np.mean(a.mi[ia] - b.mi[ib]))) < 1e-6


@pytest.mark.parametrize("row_window", [0, 1, 100, 128, 300, 384, 700, 4096])
@pytest.mark.parametrize("n_loci", [700, 1000, 1300])
def test_row_window_resolves_as_the_reference(n_loci, row_window):
    """Explicit widths round to tiles and tile Lp exactly, a width at or
    past Lp means full-width rows, and auto stays full width below 2^17
    padded columns: the reference's ``row_window`` and ``Lp``
    (tests/test_engine.py:413-428)."""
    al = random_alignment(n_samples=4, n_loci=n_loci, seed=96)
    _, st = build_device_data(al, EngineConfig(tile=TILE, row_window=row_window),
                              torch.device("cpu"))
    _, ref = jax_build_device_data(al, JaxConfig(tile=TILE, row_window=row_window))
    assert (st.row_window, st.Lp) == (ref.row_window, ref.Lp)
    if st.row_window:
        assert st.row_window % TILE == 0 and st.Lp % st.row_window == 0
        assert st.Lp >= n_loci
    else:
        assert st.Lp == -(-n_loci // TILE) * TILE


def test_auto_rules():
    """"auto": j-windows of 2^16 columns past 2^17 padded columns (the
    reference's numbers, solver.py:1018-1027), codes storage past
    AUTO_CODES_PAST bytes of dense one-hot."""
    assert resolve_row_window(0, 1 << 17, 512) == (0, 1 << 17)
    assert resolve_row_window(0, (1 << 17) + 512, 512) == (44032, 132096)
    assert resolve_row_window(0, 998400, 512) == (62464, 999424)
    assert resolve_row_window(65536, 998400, 512) == (62464, 999424)
    assert resolve_row_window(1, 998400, 512) == (0, 998400)
    al = random_alignment(n_samples=45, n_loci=300, seed=8)
    cpu = torch.device("cpu")
    dense_bytes = 45 * 384 * 5  # int8 fixed14
    for limit, codes in ((dense_bytes, False), (dense_bytes - 1, True)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(solver, "AUTO_CODES_PAST", limit)
            _, st = build_device_data(al, EngineConfig(tile=TILE), cpu)
        assert st.int8_mode == "fixed14" and st.onehot_codes == codes
    _, st = build_device_data(al, EngineConfig(tile=TILE, onehot_storage="codes"), cpu)
    assert st.onehot_codes
    with pytest.raises(ValueError, match="onehot_storage"):
        build_device_data(al, EngineConfig(tile=TILE, onehot_storage="sparse"), cpu)
    with pytest.raises(ValueError, match="row_window"):
        build_device_data(al, EngineConfig(tile=TILE, row_window=-1), cpu)


@pytest.mark.parametrize("fits", [False, True])
def test_auto_keeps_dense_full_width_rows_where_they_fit(fits):
    """Where dense full-width rows fit in half of a card's memory
    (``dense_fits``, never on the CPU), "auto" keeps them past 2^17
    columns; elsewhere "auto" is the reference's rule.  Explicit choices
    stand either way."""
    al = random_alignment(n_samples=4, n_loci=140000, seed=3)
    cpu = torch.device("cpu")
    assert not solver.dense_fits(4, 140032, TILE, torch.int8, cpu)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solver, "dense_fits", lambda *a: fits)
        _, st = build_device_data(al, EngineConfig(tile=TILE), cpu)
        assert (st.row_window, st.Lp, st.onehot_codes) == ((0, 140032, False) if fits
                                                            else (46720, 140160, False))
        _, st = build_device_data(al, EngineConfig(tile=TILE, onehot_storage="codes"), cpu)
        assert st.onehot_codes and (st.row_window, st.Lp) == (46720, 140160)
        _, st = build_device_data(al, EngineConfig(tile=TILE, row_window=65536), cpu)
        assert not st.onehot_codes and (st.row_window, st.Lp) == (46720, 140160)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_expand_codes_equals_k_major_of_the_onehot(dtype):
    """At 45 samples (no multiple of the 16-byte row pad) the expansion of
    any BW-aligned column range is ``k_major`` of the slab one-hot, pad
    samples and pad columns zero, bit for bit."""
    al = random_alignment(n_samples=45, n_loci=600, seed=9, gap_frac=0.2)
    cfg = EngineConfig(tile=TILE, mxu_int8="auto" if dtype == torch.int8 else "off")
    data, st = build_device_data(al, cfg, torch.device("cpu"), keep_onehot=True)
    assert data.onehot.dtype == dtype
    want = k_major(data.onehot)
    codes_k = codes_k_major(data.codes, dtype)
    assert codes_k.shape == (st.Lp, want.shape[1]) and want.shape[1] % (16 // dtype.itemsize) == 0
    for c0, n in ((0, st.Lp), (128, 256), (512, 128)):
        got = expand_codes(codes_k, c0, n, dtype)
        assert got.dtype == dtype and torch.equal(got, want[c0 * 5:(c0 + n) * 5])
    out = torch.full((256 * 5, want.shape[1]), 7, dtype=dtype)
    assert expand_codes(codes_k, 256, 256, dtype, out=out) is out
    assert torch.equal(out, want[256 * 5:512 * 5])


@pytest.mark.parametrize("mode", list(MODES))
def test_codes_engine_operands_equal_the_dense_ones(mode):
    """Every item's K1 and B3 arguments in codes storage hold the dense
    engine's values (its j side a view of the one reused buffer)."""
    al, mxu = mode_alignment(mode, n_samples=45, n_loci=700, seed=74)
    dense = MIEngine(al, EngineConfig(tile=TILE, mxu_int8=mxu, row_window=256), device="cpu")
    codes = MIEngine(al, EngineConfig(tile=TILE, mxu_int8=mxu, row_window=256,
                                      onehot_storage="codes"), device="cpu")
    assert codes._onehot_k is None and dense._onehot_k is not None
    for i0 in (0, 384):
        for j0, W in codes.row_windows(i0):
            a, b = codes.row_dual_args(i0, j0, W), dense.row_dual_args(i0, j0, W)
            assert a[2].untyped_storage().data_ptr() == codes._slab_j.untyped_storage().data_ptr()
            for x, y in zip(a, b):
                if isinstance(x, torch.Tensor):
                    assert x.stride(0) == y.stride(0) and torch.equal(x, y)
                else:
                    assert x == y


@pytest.mark.parametrize("with_wog,ld", [(False, 0), (True, 30)])
def test_row_select_plain_windows_equal_a_cut_of_the_full_row(with_wog, ld):
    """``row_select_plain`` on the columns [j0, j0 + W) of a block-row, j0
    left of, at and right of i0: its edges are the full-width selection's
    edges in those columns, in the same order, and the windows' colmax
    together is the full row's, bit for bit."""
    rng = np.random.default_rng(5)
    T, Lp, L, i0 = 128, 1024, 1000, 256
    mi = torch.from_numpy((rng.random((T, Lp)) * 1.25 - 0.25).astype(np.float32))
    wog = torch.from_numpy(rng.random((T, Lp)).astype(np.float32)) if with_wog else None
    gap = torch.from_numpy(rng.random(Lp) < 0.3)
    orig = torch.from_numpy(np.sort(rng.choice(3000, Lp, replace=False)).astype(np.int32))
    colmax0 = torch.from_numpy(np.where(rng.random(Lp) < 0.3, -np.inf,
                                        rng.random(Lp) * 0.9).astype(np.float32))
    kw = dict(n_loci=L, threshold=0.6, ld_threshold=ld, linear_genome=False, genome_size=3000)

    def select(buf, wbuf, j0):
        store = EdgeStore(1 << 16, with_wog, torch.device("cpu"))
        colmax = colmax0.clone()
        row_select_plain(buf, wbuf, gap, orig, colmax, store, i0, j0=j0, **kw)
        return [a[:int(store.count)] for a in store.arrays()], colmax

    full, cm_full = select(mi[:, i0:].contiguous(), None if wog is None else wog[:, i0:], i0)
    assert len(full[0]) > 1000
    cm_windows = colmax0.clone()
    for j0, W in ((0, 384), (128, 256), (256, 256), (512, 256), (768, 256)):
        cols = slice(j0, j0 + W)
        got, cm = select(mi[:, cols].contiguous(), None if wog is None else wog[:, cols], j0)
        keep = (full[1] >= j0) & (full[1] < j0 + W)
        for a, b in zip(got, full):
            assert torch.equal(a, b[keep])
        assert bool((got[1] > got[0]).all())
        cm_windows = torch.maximum(cm_windows, cm)  # no -0 among these values
    assert torch.equal(cm_windows.view(torch.int32), cm_full.view(torch.int32))


@pytest.mark.parametrize("storage", ["dense", "codes"])
def test_windowed_kill_then_resume_equals_clean_run(tmp_path, storage):
    """A windowed sweep killed after 3 of 6 block-rows, snapshots every 2
    rows: the snapshot holds whole rows only, and the resumed sweep
    (in the other storage) returns the clean full-width run's edges in
    order (tests/test_checkpoint.py:184)."""
    al = random_alignment(n_samples=48, n_loci=700, seed=61, gap_frac=0.15)
    cfg = EngineConfig(tile=TILE, wog_fetch="full", row_window=256, onehot_storage=storage)
    clean = MIEngine(al, dataclasses.replace(cfg, row_window=1, onehot_storage="dense"),
                     device="cpu").sweep(0.02)
    path = str(tmp_path / "win.ckpt")
    progress, _ = killer(3)
    eng = MIEngine(al, cfg, device="cpu")
    assert eng.statics.row_window == 256
    with pytest.raises(Killed):
        eng.sweep(0.02, progress=progress, checkpoint_path=path, checkpoint_every=2)
    saved = ck.load(path, ck.params_key(eng.statics, 0.02))
    assert saved is not None and saved.done_rows == {0, 128}
    assert set(np.unique(saved.ipos[0] // TILE * TILE)) == {0, 128}
    other = "codes" if storage == "dense" else "dense"
    resumed = MIEngine(al, dataclasses.replace(cfg, onehot_storage=other), device="cpu")
    progress, seen = killer(-1)
    rec = {}
    with recording(rec):
        got = resumed.sweep(0.02, progress=progress, checkpoint_path=path)
    # the 4 rows not in the snapshot, 6 items in all, none swept again
    assert seen == [256, 384, 512, 640] and rec["counters"]["sweep_items"] == 6
    assert rec["counters"]["rows_reswept"] == 0
    assert_same_edges(got, clean)
    assert not os.path.exists(path)


def write_wide_fasta(tmp_path):
    al = random_alignment(n_samples=40, n_loci=1000, seed=52, gap_frac=0.1)
    al.codes[:, 900] = al.codes[:, 60]  # a planted outlier coupling
    fasta = str(tmp_path / "wide.fasta")
    write_fasta(fasta, al)
    return fasta


def read_dir(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def test_cli_with_both_flags_writes_the_same_files(tmp_path, capsys):
    fasta = write_wide_fasta(tmp_path)
    args = [fasta, "-v", "--seed", "3", "--tile", "128", "--mi-values", "3000"]
    assert torch_main(args + ["--output-dir", str(tmp_path / "plain")]) == 0
    assert "dense one-hot, full-width rows" in capsys.readouterr().out
    assert torch_main(args + ["--onehot-storage", "codes", "--row-window", "256",
                              "--output-dir", str(tmp_path / "flags")]) == 0
    out = capsys.readouterr().out
    assert "codes one-hot, j-windows of 256 columns" in out and "not yet ported" not in out
    plain = read_dir(tmp_path / "plain")
    assert len(plain) >= 2 and read_dir(tmp_path / "flags") == plain


WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    from spydrpick_torch.core.alignment import Alignment
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.parallel.distributed import initialize_distributed, shutdown
    from spydrpick_torch.parallel.mesh import ShardedEngineView, make_mesh, sharded_sweep

    addr, world, rank, k, storage, inp, out = sys.argv[1:]
    initialize_distributed(addr, int(world), int(rank))
    mesh = make_mesh(int(k))
    case = np.load(inp)
    codes, w = case["codes"], case["weights"]
    S, L = codes.shape
    al = Alignment(codes, [f"s{i}" for i in range(S)], "t", np.arange(L), L, w)
    res = {}
    for wog in ("outliers", "full"):
        cfg = EngineConfig(tile=128, wog_fetch=wog, row_window=256, onehot_storage=storage)
        eng = ShardedEngineView(al, cfg, mesh) if int(k) > 1 else MIEngine(al, cfg)
        assert eng.statics.row_window == 256
        e = sharded_sweep(eng, float(case["thr"]), mesh).sort_desc()
        for f in ("ipos", "jpos", "mi", "mi_wog", "colmax"):
            res[f"{wog}/{f}"] = getattr(e, f)
    assert "jax" not in sys.modules
    np.savez(f"{out}/rank{rank}.npz", **res)
    shutdown()
''')

SHARDED = {"rows_2x1_dense": (2, 1, "dense"), "samples_1x2_codes": (2, 2, "codes")}


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("window_mesh")
    al = random_alignment(n_samples=45, n_loci=900, seed=49, gap_frac=0.1)
    al.codes[:, 700] = al.codes[:, 9]
    thr = 0.03
    np.savez(d / "case.npz", codes=al.codes, weights=al.weights, thr=np.array(thr))
    (d / "worker.py").write_text(WORKER)
    jobs, owners = [], []
    for name, (world, k, storage) in SHARDED.items():
        out = d / name
        out.mkdir()
        port = free_port()
        jobs += [[sys.executable, str(d / "worker.py"), f"127.0.0.1:{port}", str(world),
                  str(r), str(k), storage, str(d / "case.npz"), str(out)] for r in range(world)]
        owners.append((name, world, out))
    spawn(jobs)
    single = {}
    for wog in WOGS:
        e = MIEngine(al, EngineConfig(tile=TILE, wog_fetch=wog, row_window=1), device="cpu")
        single[wog] = e.sweep(thr).sort_desc()
    return {name: [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
            for name, world, out in owners}, single


@pytest.mark.parametrize("wog", WOGS)
@pytest.mark.parametrize("mesh", list(SHARDED))
def test_sharded_windowed_sweep_equals_one_process(sharded_runs, mesh, wog):
    """Two gloo ranks sweeping windowed items (rows-sharded, dense; and
    sample-sharded, each rank expanding its own codes): every rank's
    EdgeSet is the one-process full-width sweep's bit for bit (fixed14)."""
    runs, single = sharded_runs
    want = single[wog]
    assert want.n_edges > 1000
    for rank in runs[mesh]:
        for f in FIELDS:
            np.testing.assert_array_equal(rank[f"{wog}/{f}"], getattr(want, f), err_msg=f)
