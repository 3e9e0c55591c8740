"""Import boundary of the PyTorch port and the no-GPU behaviour of
chip_smoke.py.  Each check runs in a fresh interpreter, because this test
process has jax imported already (tests/conftest.py)."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's host modules that import without jax, which the port reuses
ALLOWED_REFERENCE = (
    "spydrpick_tpu", "spydrpick_tpu.version", "spydrpick_tpu.core",
    "spydrpick_tpu.core.alignment", "spydrpick_tpu.core.alphabet",
    "spydrpick_tpu.core.filter", "spydrpick_tpu.core.distance",
    "spydrpick_tpu.io", "spydrpick_tpu.io.fasta", "spydrpick_tpu.io.loci",
    "spydrpick_tpu.io.writers", "spydrpick_tpu.native",
    "spydrpick_tpu.native.aracne_native", "spydrpick_tpu.native.fasta_native",
    "spydrpick_tpu.native.format_native", "spydrpick_tpu.utils",
    "spydrpick_tpu.utils.stopwatch", "spydrpick_tpu.utils.uniquefile",
)


def run_python(code_or_args, cwd=ROOT):
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_port_imports_without_jax():
    res = run_python(
        "import sys, spydrpick_torch, spydrpick_torch.cli, spydrpick_torch.pipeline\n"
        "import spydrpick_torch.engine.solver, spydrpick_torch.core.weights\n"
        "print('jax' in sys.modules)\n"
        "print(' '.join(sorted(m for m in sys.modules if m.startswith('spydrpick_tpu'))))")
    assert res.returncode == 0, res.stderr
    has_jax, ref_modules = res.stdout.splitlines()
    assert has_jax == "False"
    assert set(ref_modules.split()) <= set(ALLOWED_REFERENCE)


def test_version_banner_names_torch_and_device():
    res = run_python(["-m", "spydrpick_torch", "--version"])
    assert res.returncode == 0, res.stderr
    assert "spydrpick-torch version" in res.stdout and "torch " in res.stdout
    assert "device" in res.stdout


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
