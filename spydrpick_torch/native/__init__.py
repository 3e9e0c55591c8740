"""Native (C++) host kernels of the port, with their ctypes loaders: the
ARACNE owner-scan (aracne.cpp) and the couplings-row formatter
(format.cpp), copies of ``spydrpick_tpu/native``, and the mmap FASTA
parser (fasta.cpp), which gives the results of the JAX package's parser
from one parallel walk of the file.

Each loader builds its library at first use with the reference's flags
(``g++ -O3 -std=c++17 -fopenmp -shared -fPIC``) into ``build/native/`` of
the checkout, never beside the sources, and rebuilds it when the source
is newer.  Processes of a sharded run may build at once: each compiles
into a file of its own and renames it into place.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

SRC_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "native"
GXX_FLAGS = ["-O3", "-std=c++17", "-fopenmp", "-shared", "-fPIC"]


def build_library(name: str) -> pathlib.Path:
    """``build/native/lib<name>.so`` from ``<name>.cpp``, compiled unless
    it is newer than the source; raises CalledProcessError on a failed
    build."""
    src = SRC_DIR / f"{name}.cpp"
    lib = BUILD_DIR / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)], check=True,
                       capture_output=True)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib
