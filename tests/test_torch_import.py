"""Import boundary of the PyTorch port, its device rule and the no-GPU
behaviour of chip_smoke.py.  Each check runs in a fresh interpreter,
because this test process has jax imported already (tests/conftest.py)."""

import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules of the JAX package and of jax in the interpreter, and the native
# libraries mapped into it from the JAX package's directory
REPORT = (
    "import sys\n"
    "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
    "'spydrpick_tpu'))))\n"
    "print(sorted({l.split()[-1] for l in open('/proc/self/maps') "
    "if 'spydrpick_tpu' in l}))\n")


def run_python(code_or_args, cwd=ROOT, cpu=True):
    """``python -c code`` (or ``python *args``) in a fresh interpreter; with
    ``cpu`` the port is asked for the CPU, as a run without a GPU must be."""
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "SPYDRPICK_TORCH_DEVICE")}
    if cpu:
        env["SPYDRPICK_TORCH_DEVICE"] = "cpu"
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def planted_fasta(path):
    """The planted-pair alignment of the verify recipe (column 300 copies
    column 10), written as FASTA without either package."""
    rng = np.random.default_rng(42)
    S, L = 120, 400
    codes = np.repeat(rng.integers(0, 4, size=(1, L)), S, axis=0)
    mut = rng.random((S, L)) < 0.15
    codes[mut] = rng.integers(0, 4, size=mut.sum())
    codes[:, 300] = codes[:, 10]
    codes[rng.random((S, L)) < 0.03] = 4
    alphabet = np.frombuffer(b"ACGT-", dtype=np.uint8)
    with open(path, "wb") as f:
        for i, row in enumerate(codes):
            f.write(b">s%d\n" % i + alphabet[row].tobytes() + b"\n")
    return str(path)


def test_port_imports_without_jax():
    res = run_python(
        "import spydrpick_torch, spydrpick_torch.cli, spydrpick_torch.pipeline\n"
        "import spydrpick_torch.engine.solver, spydrpick_torch.core.weights\n"
        "import spydrpick_torch.parallel.mesh, spydrpick_torch.io.writers\n"
        "import spydrpick_torch.plot, spydrpick_torch.ops.reference\n" + REPORT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == ["[]", "[]"]


def test_cpu_cli_run_stays_inside_the_port(tmp_path):
    """A whole CLI run on the CPU (FASTA parse, filter, weights, sweep,
    ARACNE and the couplings formatter, native libraries included) loads
    no module of jax or of the JAX package and no library from its
    directory; the planted pair ranks first."""
    fasta = planted_fasta(tmp_path / "verif.fasta")
    out = tmp_path / "out"
    res = run_python(
        "from spydrpick_torch.cli import main\n"
        f"assert main([{fasta!r}, '--ld-threshold', '20', '--seed', '7', "
        f"'--output-dir', {str(out)!r}]) == 0\n" + REPORT)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[-2:] == ["[]", "[]"], lines[-2:]
    assert "cpu device (SPYDRPICK_TORCH_DEVICE=cpu" in res.stdout
    (couplings,) = [p for p in out.iterdir() if p.name.endswith("edges")]
    assert couplings.read_text().split("\n", 1)[0].split()[:2] == ["11", "301"]


def test_cli_without_gpu_or_cpu_request_refuses(tmp_path):
    """Without a GPU and without SPYDRPICK_TORCH_DEVICE=cpu the CLI exits
    non-zero, names the variable and writes nothing."""
    import torch

    if torch.cuda.is_available():
        return  # the rule is about machines without a GPU
    fasta = planted_fasta(tmp_path / "verif.fasta")
    out = tmp_path / "out"
    res = run_python(["-m", "spydrpick_torch", fasta, "--output-dir", str(out)], cpu=False)
    assert res.returncode != 0
    assert "SPYDRPICK_TORCH_DEVICE" in res.stderr
    assert not out.exists()
    assert sorted(os.listdir(tmp_path)) == ["verif.fasta"]


def test_version_banner_names_torch_and_device():
    res = run_python(["-m", "spydrpick_torch", "--version"])
    assert res.returncode == 0, res.stderr
    assert "spydrpick-torch version" in res.stdout and "torch " in res.stdout
    assert "cpu device" in res.stdout


def test_version_banner_without_a_device_does_not_raise():
    """The banner never asks for a device it cannot have: without a GPU
    and without the CPU request it says so and exits 0."""
    import torch

    res = run_python(["-m", "spydrpick_torch", "--version"], cpu=False)
    assert res.returncode == 0, res.stderr
    assert ("cuda device" if torch.cuda.is_available() else "no CUDA device") in res.stdout


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Without CUDA the smoke test exits non-zero and prints no result; a
    directory holding only chip_smoke.py fails, with or without a GPU."""
    import torch

    if not torch.cuda.is_available():
        res = run_python(["chip_smoke.py"])
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    alone = run_python(["chip_smoke.py"], cwd=tmp_path)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout
