"""Sweep checkpoint and resume of the PyTorch port (spydrpick_torch/engine/
checkpoint.py, ``MIEngine.sweep(checkpoint_path=...)``, ``--checkpoint``)
on the CPU, mirroring tests/test_checkpoint.py: the copy of the checkpoint
module against the original, kill-then-resume against a clean run in the
lazy and the full wog modes, and CLI resume byte for byte.  The port's
tile is a multiple of 128, so these alignments are 640+ columns wide to
give several block-rows."""

import os

import numpy as np
import pytest

from spydrpick_tpu.engine import checkpoint as jax_ck
from spydrpick_tpu.io.fasta import write_fasta
from spydrpick_torch.cli import main as torch_main
from spydrpick_torch.engine import checkpoint as ck
from spydrpick_torch.engine.solver import EngineConfig, MIEngine
from spydrpick_torch.pipeline import PipelineOptions, engine_config, load_and_preprocess
from spydrpick_torch.utils.profiling import recording, seconds

from tests.conftest import random_alignment

TILE = 128
THR = 0.02


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    """These runs ask for the CPU, as a CLI run on a machine without a GPU
    must (spydrpick_torch/device.py); module-scoped, so that the module's
    fixtures that run the CLI see it too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        yield


class Killed(Exception):
    pass


def killer(after: int):
    """A progress callback that raises after ``after`` block-rows."""
    seen = []

    def progress(lo, hi, n, dt):
        seen.append(lo)
        if len(seen) == after:
            raise Killed

    return progress, seen


def engine(wog_fetch, seed=61, n_loci=700):
    al = random_alignment(n_samples=48, n_loci=n_loci, seed=seed, gap_frac=0.15)
    return MIEngine(al, EngineConfig(tile=TILE, wog_fetch=wog_fetch), device="cpu")


def assert_equal_edges(a, b):
    for f in ("ipos", "jpos", "mi", "mi_wog", "colmax"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "sweep.ckpt")
    c = ck.SweepCheckpoint(
        params_key="k1", done_rows={0, 128, 256}, colmax=np.array([0.1, 0.2]),
        ipos=[np.array([1, 2]), np.array([5])], jpos=[np.array([3, 4]), np.array([9])],
        mi=[np.array([0.5, 0.6]), np.array([0.7])],
        mi_wog=[np.array([0.4, 0.55]), np.array([0.65])],
    )
    ck.save(path, c)
    got = ck.load(path, "k1")
    assert got is not None and got.done_rows == {0, 128, 256}
    np.testing.assert_array_equal(got.colmax, c.colmax)
    for f in ("ipos", "jpos", "mi", "mi_wog"):
        np.testing.assert_array_equal(getattr(got, f)[0], np.concatenate(getattr(c, f)))
    assert ck.load(path, "other-key") is None
    assert ck.load(str(tmp_path / "missing.ckpt"), "k1") is None
    assert sorted(os.listdir(tmp_path)) == ["sweep.ckpt"]  # no temporary left behind


@pytest.mark.parametrize("writer,reader", [(ck, jax_ck), (jax_ck, ck)])
def test_checkpoint_format_shared_with_reference(tmp_path, writer, reader):
    """The copy writes and reads the original's .npz fields."""
    path = str(tmp_path / "x.ckpt")
    rng = np.random.default_rng(3)
    c = writer.SweepCheckpoint("key", {0, 512}, rng.random(40), [np.arange(5)],
                               [np.arange(5) + 7], [rng.random(5)], [rng.random(5)])
    writer.save(path, c)
    got = reader.load(path, "key")
    assert got is not None and got.done_rows == c.done_rows
    np.testing.assert_array_equal(got.colmax, c.colmax)
    for f in ("ipos", "jpos", "mi", "mi_wog"):
        np.testing.assert_array_equal(getattr(got, f)[0], getattr(c, f)[0])
    with np.load(path) as z:
        assert sorted(z.files) == ["colmax", "done_rows", "ipos", "jpos", "mi", "mi_wog",
                                   "params_key"]


def test_snapshot_is_uncompressed_and_each_package_loads_the_others(tmp_path):
    """The port writes the reference's fields and dtypes without zlib; the
    reference's compressed file loads in the port and the port's file in
    the reference, with the same arrays."""
    import zipfile

    rng = np.random.default_rng(5)
    n = 20000
    c = ck.SweepCheckpoint("key", {0, 512, 1024}, rng.random(1500),
                           [rng.integers(0, 1500, n)], [rng.integers(0, 1500, n)],
                           [rng.random(n)], [rng.random(n)])
    port, ref = str(tmp_path / "port.ckpt"), str(tmp_path / "ref.ckpt")
    ck.save(port, c)
    jax_ck.save(ref, c)
    with zipfile.ZipFile(port) as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_STORED}
    with zipfile.ZipFile(ref) as z:
        assert zipfile.ZIP_DEFLATED in {i.compress_type for i in z.infolist()}
    assert os.path.getsize(port) > os.path.getsize(ref)
    with np.load(port) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
    for reader, path in ((jax_ck, port), (ck, ref)):
        got = reader.load(path, "key")
        assert got is not None and got.done_rows == c.done_rows
        np.testing.assert_array_equal(got.colmax, c.colmax)
        for f in ("ipos", "jpos", "mi", "mi_wog"):
            np.testing.assert_array_equal(getattr(got, f)[0], getattr(c, f)[0])


@pytest.mark.parametrize("wog_fetch", ["outliers", "full"])
def test_params_key_has_the_reference_format(wog_fetch):
    st = engine(wog_fetch, n_loci=300).statics
    assert ck.params_key(st, THR) == jax_ck.params_key(st, THR)
    assert f"lazy={wog_fetch == 'outliers'}" in ck.params_key(st, THR)
    assert f"i8={st.int8_mode}:{st.int8_scale!r}" in ck.params_key(st, THR)


@pytest.mark.parametrize("wog_fetch", ["outliers", "full"])
def test_kill_then_resume_equals_clean_run(tmp_path, wog_fetch):
    """Killed after 3 of 6 block-rows with a snapshot every 2 rows, the
    resumed sweep sweeps only the rows the snapshot lacks and returns the
    clean run's edges in the same order: ipos and jpos exact; mi, wog and
    colmax bit for bit (lazy wog resolved over the whole resumed set)."""
    clean = engine(wog_fetch).sweep(THR)
    path = str(tmp_path / "sweep.ckpt")
    progress, _ = killer(3)
    with pytest.raises(Killed):
        engine(wog_fetch).sweep(THR, progress=progress, checkpoint_path=path,
                                checkpoint_every=2)
    eng = engine(wog_fetch)
    saved = ck.load(path, ck.params_key(eng.statics, THR))
    assert saved is not None and saved.done_rows == {0, 128}
    assert set(np.unique(saved.ipos[0] // TILE * TILE)) == {0, 128}
    if wog_fetch == "outliers":  # lazy snapshots hold mi placeholders
        np.testing.assert_array_equal(saved.mi_wog[0], saved.mi[0])
    progress, seen = killer(-1)
    rec = {}
    with recording(rec):
        resumed = eng.sweep(THR, progress=progress, checkpoint_path=path)
    # the rows not in the snapshot, one item each, each swept once
    assert seen == [256, 384, 512, 640] and rec["counters"]["sweep_items"] == 4
    assert rec["counters"]["rows_reswept"] == 0
    assert_equal_edges(resumed, clean)
    assert not os.path.exists(path)
    if wog_fetch == "outliers":
        assert (resumed.mi_wog != resumed.mi).any()  # candidates were resolved


def test_lazy_and_full_checkpoints_are_not_interchangeable(tmp_path):
    """A lazy snapshot must not resume a full-wog run (placeholders would
    masquerade as exact wog): the key separates them and the run starts
    afresh."""
    path = str(tmp_path / "x.ckpt")
    progress, _ = killer(3)
    with pytest.raises(Killed):
        engine("outliers").sweep(THR, progress=progress, checkpoint_path=path,
                                 checkpoint_every=1)
    full = engine("full")
    assert ck.load(path, ck.params_key(full.statics, THR)) is None
    progress, seen = killer(-1)
    resumed = full.sweep(THR, progress=progress, checkpoint_path=path)
    assert len(seen) == 6  # every row swept again
    assert_equal_edges(resumed, engine("full").sweep(THR))
    assert not os.path.exists(path)


def test_checkpoint_written_during_sweep_and_removed_on_completion(tmp_path):
    path = str(tmp_path / "s.ckpt")
    eng = engine("outliers")
    key = ck.params_key(eng.statics, THR)
    saved_rows = []

    def progress(lo, hi, n, dt):
        snap = ck.load(path, key)
        saved_rows.append(None if snap is None else sorted(snap.done_rows))

    rec = {}
    with recording(rec):
        eng.sweep(THR, progress=progress, checkpoint_path=path, checkpoint_every=2)
    # progress runs before each save; saves after rows 2 and 4, none after the last
    assert saved_rows == [None, None, [0, 128], [0, 128], [0, 128, 256, 384],
                          [0, 128, 256, 384]]
    saves = [sp for sp in rec["spans"] if sp["path"] == "rows.save"]
    assert len(saves) == 2 and seconds(rec["spans"], "rows.save") > 0
    assert not os.path.exists(path)


def write_cli_fasta(tmp_path):
    al = random_alignment(n_samples=40, n_loci=700, seed=52, gap_frac=0.1)
    al.codes[:, 600] = al.codes[:, 60]  # a planted outlier coupling
    fasta = str(tmp_path / "cli_ck.fasta")
    write_fasta(fasta, al)
    return fasta


CLI_ARGS = ["--mi-threshold", "0.05", "--seed", "3", "--no-filter-alignment",
            "--no-sample-reweighting", "--tile", "128"]


def read_dir(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def test_cli_resume_outputs_match(tmp_path):
    """A snapshot written by a killed sweep of the engine that
    ``run_pipeline`` builds is picked up by ``--checkpoint`` (same flags,
    same key) and the outputs equal an uncheckpointed run's byte for byte."""
    fasta = write_cli_fasta(tmp_path)
    assert torch_main([fasta, *CLI_ARGS, "--output-dir", str(tmp_path / "clean")]) == 0
    opts = PipelineOptions(alignmentfile=fasta, mi_threshold=0.05, seed=3,
                           no_filter_alignment=True, no_sample_reweighting=True, tile=128)
    eng = MIEngine(load_and_preprocess(opts), engine_config(opts), device="cpu")
    assert eng.statics.wog_lazy  # the pipeline's mode
    path = str(tmp_path / "cli.ckpt")
    progress, _ = killer(4)
    with pytest.raises(Killed):
        eng.sweep(0.05, progress=progress, checkpoint_path=path, checkpoint_every=3)
    assert ck.load(path, ck.params_key(eng.statics, 0.05)).done_rows == {0, 128, 256}

    assert torch_main([fasta, *CLI_ARGS, "--checkpoint", path,
                       "--output-dir", str(tmp_path / "resumed")]) == 0
    assert not os.path.exists(path)
    clean = read_dir(tmp_path / "clean")
    assert len(clean) == 3 and read_dir(tmp_path / "resumed") == clean


def test_cli_checkpointed_run_matches_and_ignores_stale_keys(tmp_path):
    """An uninterrupted ``--checkpoint`` run writes the same bytes; a
    snapshot made under other parameters is ignored, and removed when the
    run completes."""
    fasta = write_cli_fasta(tmp_path)
    assert torch_main([fasta, *CLI_ARGS, "--output-dir", str(tmp_path / "clean")]) == 0
    path = str(tmp_path / "stale.ckpt")
    ck.save(path, ck.SweepCheckpoint("another run", {0, 128}, np.zeros(700),
                                     [np.array([0])], [np.array([1])], [np.array([9.0])],
                                     [np.array([9.0])]))
    assert torch_main([fasta, *CLI_ARGS, "--checkpoint", path, "--checkpoint-every", "1",
                       "--output-dir", str(tmp_path / "ck")]) == 0
    assert not os.path.exists(path)
    assert read_dir(tmp_path / "ck") == read_dir(tmp_path / "clean")
