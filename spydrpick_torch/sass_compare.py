"""Compare the machine code (SASS) of the port's CUDA kernels with that of
another source tree, to show that an edit left a kernel's code as it was.

    python -m spydrpick_torch.sass_compare OTHER_CSRC [--out DIR]

Compiles every ``*.cu`` file that ``spydrpick_torch/csrc`` and
``OTHER_CSRC`` both hold, with the device flags of ``ops/cuda_build.py``,
each by its own ``nvcc`` (all started together), into cubins under
``--out`` (default ``build/sass/``), disassembles them with ``cuobjdump
-sass`` and prints one line per kernel instance: its instruction count in
this tree and in the other, and whether the instructions are identical.
Kernel names are matched with the anonymous namespace's name removed (it
holds a hash of the build and one of the source, which changes with any
edit of the file).  Needs the CUDA toolkit, not a GPU.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import re
import subprocess
import sys

from spydrpick_torch.ops import cuda_build

_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/")


def plain_name(name: str) -> str:
    """A mangled kernel name with its anonymous namespace's length-prefixed
    name (``44_GLOBAL__N__<hash>_11_xtab_mma_cu_<hash>``) cut to
    ``_GLOBAL__N_``."""
    m = re.search(r"(\d+)_GLOBAL__N__", name)
    if m is None:
        return name
    return name[:m.start()] + "_GLOBAL__N_" + name[m.end(1) + int(m.group(1)):]


def sass_functions(text: str) -> dict[str, list[str]]:
    """``cuobjdump -sass`` output -> {kernel name: instruction lines}, the
    name without its anonymous namespace's (``plain_name``)."""
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = block.partition("\n")
        out[plain_name(name.strip())] = [line.strip() for line in body.splitlines()
                                         if _INSTRUCTION.search(line)]
    return out


def compile_sass(sources: list[pathlib.Path], out_dir: pathlib.Path) -> list[str]:
    """Each source's SASS text, compiled in parallel into ``out_dir``."""
    nvcc = cuda_build.nvcc_path()
    cubins = [out_dir / f"{i}_{src.stem}.cubin" for i, src in enumerate(sources)]
    procs = [subprocess.Popen([nvcc, *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-cubin",
                               "-o", str(cubin), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, cubin in zip(sources, cubins)]
    for src, proc in zip(sources, procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return [subprocess.run([cuobjdump, "-sass", str(c)], capture_output=True, text=True,
                           check=True).stdout for c in cubins]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path, default=cuda_build.BUILD_DIR.parent / "sass")
    args = ap.parse_args(argv)
    names = sorted(p.name for p in cuda_build.CSRC.glob("*.cu")
                   if (args.other_csrc / p.name).exists())
    args.out.mkdir(parents=True, exist_ok=True)
    texts = compile_sass([cuda_build.CSRC / n for n in names]
                         + [args.other_csrc / n for n in names], args.out)
    for k, name in enumerate(names):
        mine, other = sass_functions(texts[k]), sass_functions(texts[len(names) + k])
        for fn in sorted(set(mine) | set(other)):
            a, b = mine.get(fn), other.get(fn)
            state = ("only here" if b is None else "only there" if a is None
                     else "identical" if a == b else "differs")
            print(f"{name} {fn}: {len(a or [])} instructions here, {len(b or [])} there, {state}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
