"""Build and load the port's CUDA kernels (``spydrpick_torch/csrc``).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all started together, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so the build takes
seconds), at the first kernel launch of a process, into
``build/kernels/`` of the checkout.  ``ctypes`` loads it; the wrappers in
``ops/mi_kernels.py``, ``ops/compact.py``, ``ops/aracne.py``,
``ops/format.py``, ``ops/columns.py`` and ``ops/pairs.py`` pass device
pointers and
PyTorch's current CUDA stream.  The ranks of a sharded run may build at
once: each compiles into files of its own and renames the library into
place, so none loads a half-written one.  A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libspydrpick_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None

_vp, _i, _ll, _d, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_double, ctypes.c_float)
_SIGNATURES = {
    # dtype, xi_hi, xi_lo, xj, ldi, ldj, ipf, jpf, out, ldo, S, TI, TJ,
    # bw_i, bw_j, n_passes, m0, m1, acc_scale, pc, stream (ldi, ldj: the
    # K-major operands' row strides, here and for B3 and B4)
    "spk_mi_tile_single": [_i, _vp, _vp, _vp, _ll, _ll, _vp, _vp, _vp, _ll,
                           _i, _i, _i, _i, _i, _i, _d, _d, _f, _f, _vp],
    # dtype, xi_hi, xi_lo, xj, ldi, ldj, ipf, jpf, ipwf, jpwf, out, out_wog,
    # ldo, S, TI, TJ, bw_i, bw_j, n_passes, m0, m1, acc_scale, pc, stream
    "spk_mi_tile_dual": [_i, _vp, _vp, _vp, _ll, _ll, _vp, _vp, _vp, _vp, _vp, _vp,
                         _ll, _i, _i, _i, _i, _i, _i, _d, _d, _f, _f, _vp],
    # dtype, xi_hi, xi_lo, xj, ldi, ldj, out, ldc, S, TI, TJ, bw_i, bw_j,
    # n_passes, m0, m1, stream
    "spk_crosstab_tile": [_i, _vp, _vp, _vp, _ll, _ll, _vp, _ll, _i, _i, _i, _i, _i, _i,
                          _d, _d, _vp],
    # C, ldc, ipf, jpf, ipwf, jpwf, out, out_wog, ldo, TI, TJ, bw_i, bw_j, pc, stream
    "spk_mi_epilogue": [_vp, _ll, _vp, _vp, _vp, _vp, _vp, _vp, _ll, _i, _i, _i, _i, _f, _vp],
    # mi, wog, gap, orig_pos, colmax, store ipos, jpos, mi, wog, count, capacity,
    # T, W, i0, j0, L, thr, ld, circular, genome, stream
    "spk_row_select": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ll,
                       _i, _i, _i, _i, _i, _f, _i, _i, _i, _vp],
    # a, b, w, E, offs, nbr, wadj, margin_add, out, stream
    "spk_aracne_scan": [_vp, _vp, _vp, _ll, _vp, _vp, _vp, _d, _vp, _vp],
    # p1, p2, dist, mi, n, len, stream
    "spk_format_lengths": [_vp, _vp, _vp, _vp, _ll, _vp, _vp],
    # p1, p2, dist, flags, mi, n, starts, out, stream
    "spk_format_rows": [_vp, _vp, _vp, _vp, _vp, _ll, _vp, _vp, _vp],
    # codes, S, L, out, stream
    "spk_column_counts": [_vp, _i, _i, _vp, _vp],
    # ci, cj, w, S, P, out, stream
    "spk_pairs_xtab": [_vp, _vp, _vp, _i, _ll, _vp, _vp],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernels unless the library is newer than every source.

    Returns (library path, compiler report); the report holds ptxas's
    per-kernel registers, shared memory and spills, and is empty when
    the existing library was reused."""
    lib = BUILD_DIR / LIB_NAME
    srcs = sorted(CSRC.glob("*.cu"))
    newest = max(p.stat().st_mtime for p in srcs + sorted(CSRC.glob("*.cuh")))
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib, ""
    nvcc = nvcc_path()
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {nvcc}); the CUDA "
                           "kernels are compiled from spydrpick_torch/csrc at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    report = ""
    try:
        for cmd, proc in zip(cmds, procs):
            out = proc.communicate()[0]
            report += out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n{out}")
        tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc={res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib, report


def load() -> ctypes.CDLL:
    """The kernels library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
