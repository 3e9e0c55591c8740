"""Auto-uniquified output paths (apegrunt ``get_unique_ofstream``,
call sites src/SpydrPick.cpp:429,459)."""

from __future__ import annotations

import pathlib


def unique_path(name: str | pathlib.Path) -> pathlib.Path:
    """Return ``name`` if free, else ``name.1``, ``name.2``, ..."""
    p = pathlib.Path(name)
    if not p.exists():
        return p
    n = 1
    while True:
        cand = p.with_name(f"{p.name}.{n}")
        if not cand.exists():
            return cand
        n += 1
