"""The port's native FASTA parser (spydrpick_torch/native/fasta.cpp: one
mapping, a parallel memchr index kept for the decode, a line-walking
decode) against the JAX package's native parser, which walks the file
byte by byte: codes, names and the exception raised, on every input, for
every way the index cuts the file into byte ranges; and its counter
fasta_slow_records."""

from __future__ import annotations

import os

import numpy as np
import pytest

from spydrpick_tpu.native import fasta_native as jax_fasta_native
from spydrpick_torch.native import fasta_native
from spydrpick_torch.pipeline import PipelineOptions, run_pipeline
from spydrpick_torch.utils import profiling

# name -> the file's bytes (None: no file)
CASES = {
    "one_line_records": b">s0\nACGTN-acgt\n>s1 desc\nTTGCA-acgn\n",
    "crlf": b">s0\r\nACGT\r\nAC\r\n>s1 x\r\nTTGC\r\nGA\r\n",
    "wrapped_equal_lines": b">a\nACG\nTAC\nGTA\n>b\nCCC\nGGG\nTTT\n",
    "wrapped_unequal_lines": b">a\nA\nCGTAC\nGT\n>b\nCCCGGGT\nTT\n",
    "tabs_and_spaces_in_lines": b">a\nAC\tGT A\n>b\n A CG\tTA\t\n",
    "cr_inside_a_line": b">a\nAC\rGT\n>b\nACGT\r\n",
    "blank_lines": b"\n>a\n\nACGT\n\n\n>b\nAC\n\nGT\n\n",
    "gt_in_a_header": b">a>b c>d\nACGT\n>e>\nTTTT\n",
    "gt_mid_sequence_line": b">a\nACGT>b\nACGT\n",
    "gt_mid_line_unaligned": b">a\nAC>b\nACGT\n",
    "no_trailing_newline": b">a\nACGT\n>b\nTTGA",
    "header_without_newline_at_the_end": b">a\nACGT\n>b",
    "leading_whitespace": b" \t\r\n\n>a\nACGT\n>b\nACGT\n",
    "empty_header": b">\nACGT\n>\nTTTT\n",
    "bytes_from_0x80": b">\xc3\xa9t\xe9\nAC\x80\xffGT\n>b\n\xfe\xfeAC\x90T\n",
    "other_letters": b">a\nacgtuNRYKM\n>b\nACGTUnrykm\n",
    "one_record": b">only\nACGTACGT\n",
    "zero_width_records": b">a\n>b\n\n>c\n",
    "unaligned": b">a\nACGT\n>b\nACG\n",
    "empty_file": b"",
    "whitespace_only": b" \n\t\r\n",
    "headerless": b"ACGT\n>a\nACGT\n",
    "missing_file": None,
    "names_over_4_mib": b">" + b"n" * (5 << 20) + b"\nACGT\n",
}


def outcome(parse, path, **kw):
    """("ok", codes, names) or ("raises", type, message)."""
    try:
        codes, names = parse(path, **kw)
    except (OSError, ValueError) as exc:
        return ("raises", type(exc), str(exc))
    return ("ok", codes.shape, codes.tobytes(), names)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_parse_equals_the_jax_parser(tmp_path, case):
    """Every case, with the default ranges and, for a small file, with the
    file cut into every count of ranges from 1 to one per byte and more:
    every record and line boundary lies on a range split."""
    data = CASES[case]
    path = str(tmp_path / f"{case}.fasta")
    if data is not None:
        with open(path, "wb") as f:
            f.write(data)
    want = outcome(jax_fasta_native.parse, path)
    assert outcome(fasta_native.parse, path) == want
    if data is not None and len(data) <= 200:
        for ranges in range(1, len(data) + 2):
            assert outcome(fasta_native.parse, path, ranges=ranges) == want, ranges


KINDS = ("record_start", "after_gt", "header_newline", "header_cr", "gt_in_header",
         "line_start", "line_newline", "line_cr", "mid_line", "tab_in_line")


def split_fasta(ranges: int, size: int = 280_000, width: int = 150) -> tuple[bytes, list]:
    """A FASTA of exactly ``ranges * (size // ranges)`` bytes, so that the
    index's range splits fall at multiples of ``size // ranges``; each
    split lands on the next boundary of KINDS in turn, blank lines before
    it taking up the difference.  Records of ``width`` codes in lines of 1
    to 60; every second record with CRLF ends and every other with a '>'
    in its header, every third with a tab in its second line.  Returns the
    bytes and the kinds placed, one a split."""
    rng = np.random.default_rng(ranges)
    chunk = size // ranges
    n = chunk * ranges
    targets = [r * chunk for r in range(1, ranges)]
    out = bytearray()
    placed: list = []

    def record(k):
        """(piece, {kind: offset in the piece}) of record k."""
        crlf = k % 2 == 0
        eol = b"\r\n" if crlf else b"\n"
        head = b">s%d" % k + (b">x y" if k % 2 else b"") + eol
        offs = {"record_start": 0, "after_gt": 1, "header_newline": len(head) - 1}
        if crlf:
            offs["header_cr"] = len(head) - 2
        else:
            offs["gt_in_header"] = head.index(b">", 1)
        yield head, offs
        left, line_no = width, 0
        while left:
            w = int(min(left, rng.integers(2, 61)))
            seq = bytes(rng.choice(np.frombuffer(b"ACGTacgtN-", np.uint8), size=w))
            tab = k % 3 == 0 and line_no == 1
            if tab:
                seq = seq[:w // 2] + b"\t" + seq[w // 2:]
            line = seq + eol
            offs = {"line_start": 0, "line_newline": len(line) - 1, "mid_line": w // 2}
            if crlf:
                offs["line_cr"] = len(line) - 2
            if tab:
                offs["tab_in_line"] = w // 2
            yield line, offs
            left -= w
            line_no += 1

    k = 0
    while True:
        pieces = list(record(k))
        if len(out) + sum(len(p) for p, _ in pieces) + 2000 > n:
            break
        for piece, offs in pieces:
            if targets:
                d, kind = targets[0] - len(out), KINDS[len(placed) % len(KINDS)]
                if d <= 1500 and kind in offs and d >= offs[kind]:
                    out += b"\n" * (d - offs[kind])
                    placed.append(kind)
                    targets.pop(0)
            out += piece
        k += 1
    out += b"\n" * (n - len(out))
    assert len(out) == n and len(placed) == ranges - 1 and not targets
    return bytes(out), placed


@pytest.mark.parametrize("ranges", [1, 2, 3, 7, 64])
def test_range_splits_on_record_and_line_boundaries(tmp_path, ranges):
    data, placed = split_fasta(ranges)
    path = str(tmp_path / "split.fasta")
    with open(path, "wb") as f:
        f.write(data)
    if ranges == 64:
        assert set(placed) == set(KINDS)
    codes, names = fasta_native.parse(path, ranges=ranges)
    want_codes, want_names = jax_fasta_native.parse(path)
    assert codes.shape == want_codes.shape and codes.shape[1] == 150
    np.testing.assert_array_equal(codes, want_codes)
    assert names == want_names


def one_line_fasta(S=12, L=300, tabs=(), seed=0, wrap=None, eol=b"\n") -> tuple[bytes, np.ndarray]:
    """Records of L codes, in one line or in lines of ``wrap``; the records
    in ``tabs`` hold a tab and a space inside their sequence.  Returns the
    bytes and the codes."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, size=(S, L)).astype(np.uint8)
    out = bytearray()
    for k in range(S):
        seq = np.frombuffer(b"ACGT-", np.uint8)[codes[k]].tobytes()
        if k in tabs:
            seq = seq[:10] + b"\t" + seq[10:100] + b" " + seq[100:]
        step = wrap or len(seq)
        out += b">s%d" % k + eol + b"".join(seq[i:i + step] + eol for i in range(0, len(seq), step))
    return bytes(out), codes


@pytest.mark.parametrize("case,slow", [
    ("one_line", 0), ("tabs_in_three", 3), ("wrapped_60", 0), ("crlf_ends", 0), ("interior_cr", 2),
])
def test_slow_records_counter(tmp_path, case, slow):
    """fasta_slow_records counts the records with a line that holds interior
    whitespace; the codes are the same either way."""
    data, codes = one_line_fasta(tabs=(0, 5, 11) if case == "tabs_in_three" else (),
                                 wrap=60 if case == "wrapped_60" else None,
                                 eol=b"\r\n" if case == "crlf_ends" else b"\n")
    if case == "interior_cr":  # in records 1 and 4, one inside a line ending in \r
        lines = data.split(b"\n")
        lines[3] = lines[3][:7] + b"\r" + lines[3][7:]
        lines[9] = lines[9][:50] + b"\r" + lines[9][50:] + b"\r"
        data = b"\n".join(lines)
    path = str(tmp_path / f"{case}.fasta")
    with open(path, "wb") as f:
        f.write(data)
    tm: dict = {}
    with profiling.recording(tm):
        got, names = fasta_native.parse(path)
    np.testing.assert_array_equal(got, codes)
    assert names == [f"s{k}" for k in range(len(codes))]
    assert tm["counters"]["fasta_slow_records"] == slow
    assert tm["counters"]["fasta_bytes"] == len(data)
    assert {s["path"] for s in tm["spans"]} >= {"read", "alloc", "decode"}


def test_slow_records_in_the_verbose_counters_line(tmp_path, monkeypatch, capsys):
    data, _ = one_line_fasta(S=40, L=128, tabs=(1, 2), seed=3)
    path = str(tmp_path / "tabs.fasta")
    with open(path, "wb") as f:
        f.write(data)
    monkeypatch.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
    tm: dict = {}
    run_pipeline(PipelineOptions(alignmentfile=path, output_dir=str(tmp_path / "o"), tile=128,
                                 seed=3, mi_threshold=0.0, verbose=True), timings=tm)
    line = [x for x in capsys.readouterr().out.splitlines() if "counters: " in x]
    assert len(line) == 1 and "fasta_slow_records 2" in line[0]
    assert tm["counters"]["fasta_slow_records"] == 2


def test_no_parse_state_outlives_a_parse(tmp_path):
    """Each parse reads the file as it is now: the same path rewritten
    between two parses gives the new codes."""
    path = str(tmp_path / "a.fasta")
    for seed in (0, 1):
        data, codes = one_line_fasta(seed=seed)
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(fasta_native.parse(path)[0], codes)
    os.remove(path)
    with pytest.raises(FileNotFoundError):
        fasta_native.parse(path)
