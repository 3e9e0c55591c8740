"""Trace reading of spydrpick_torch.utils.profiling (device-busy union)
and the bench alignment writer of spydrpick_torch.stage_profile."""

import numpy as np
import pytest

from spydrpick_torch.stage_profile import bench_alignment, write_inputs
from spydrpick_torch.utils.profiling import busy_union, device_intervals


def ev(cat, ts, dur, name="k"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),                  # disjoint
    ([(0, 10), (5, 15)], 15.0),                   # overlapping streams count once
    ([(0, 30), (5, 10), (12, 20)], 30.0),         # nested
    ([(20, 25), (0, 10), (10, 12)], 17.0),        # unsorted, touching
])
def test_busy_union(intervals, busy):
    assert busy_union(intervals) == busy


def test_device_intervals_filters_and_clips():
    events = [
        ev("kernel", 0, 10, "mi"),
        ev("gpu_memcpy", 8, 4, "copy"),
        ev("gpu_memset", 30, 5, "set"),
        ev("cpu_op", 0, 100, "aten::add"),          # host op: not device time
        ev("gpu_user_annotation", 0, 100, "region"),  # spans, not work
        ev("kernel", 50, 10, "late"),               # outside the window
        {"ph": "i", "cat": "kernel", "ts": 1, "name": "instant"},
    ]
    iv = device_intervals(events, lo=2.0, hi=33.0)
    assert iv == [(2.0, 10.0, "mi"), (8.0, 12.0, "copy"), (30.0, 33.0, "set")]
    assert busy_union(iv) == 13.0


def test_bench_inputs_round_trip(tmp_path):
    from spydrpick_tpu.io.fasta import read_fasta
    from spydrpick_tpu.io.loci import parse_value_list

    codes, w = bench_alignment(12, 40, seed=5)
    assert codes.max() == 4 and 0.1 <= w.min() and w.max() < 1.0
    fasta, wfile = write_inputs(str(tmp_path), "b", codes, w)
    al = read_fasta(fasta)
    np.testing.assert_array_equal(al.codes, codes)
    np.testing.assert_allclose(parse_value_list(wfile), w, rtol=0, atol=1e-9)
