"""Kernel K2 of the PyTorch port (spydrpick_torch/ops/compact.py) against
the JAX package's row compaction: ``route_rows_pallas`` in interpret mode
and the XLA ``route_rows``, at the densities and shapes of
tests/test_compact.py.  Counts and the compacted prefixes must be
bit-equal (values are moved, never computed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spydrpick_tpu.ops.compact_route import route_rows as jax_route_rows
from spydrpick_tpu.ops.compact_route import route_rows_pallas
from spydrpick_torch.ops.compact import route_rows


def rows(density, with_wog, shape, seed):
    rng = np.random.default_rng(seed)
    mi = rng.random(shape).astype(np.float32)
    wog = (mi * 0.5).astype(np.float32) if with_wog else None
    mask = rng.random(shape) < density
    return mask, mi, wog


def assert_prefixes_equal(port, counts, mi_ref, j_ref, wog_ref):
    """Port outputs vs a reference's (routed mi, routed j, routed wog):
    equal counts, equal lanes [0, count) per row, zero lanes past it."""
    omi, oj, owog, ocounts = (None if x is None else x.numpy() for x in port)
    np.testing.assert_array_equal(ocounts, counts)
    for r, n in enumerate(counts):
        np.testing.assert_array_equal(omi[r, :n], mi_ref[r, :n])
        np.testing.assert_array_equal(oj[r, :n], j_ref[r, :n])
        assert not omi[r, n:].any() and not oj[r, n:].any()
        if wog_ref is not None:
            np.testing.assert_array_equal(owog[r, :n], wog_ref[r, :n])


@pytest.mark.parametrize("with_wog", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_plain_k2_matches_pallas_route(density, with_wog):
    mask, mi, wog = rows(density, with_wog, (16, 1024), int(density * 100) + 3 + with_wog)
    r_mi, r_j, r_wog, counts = route_rows_pallas(
        jnp.asarray(mask), jnp.asarray(mi), None if wog is None else jnp.asarray(wog),
        interpret=True)
    port = route_rows(torch.from_numpy(mask), torch.from_numpy(mi),
                      None if wog is None else torch.from_numpy(wog))
    assert (port[2] is None) == (wog is None)
    assert_prefixes_equal(port, np.asarray(counts), np.asarray(r_mi), np.asarray(r_j),
                          None if r_wog is None else np.asarray(r_wog))


@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_plain_k2_matches_xla_route(density):
    mask, mi, wog = rows(density, True, (16, 1024), 11 + int(density * 10))
    jidx = np.broadcast_to(np.arange(1024, dtype=np.float32), mask.shape)
    (r_mi, r_wog, r_j), counts = jax_route_rows(
        jnp.asarray(mask), (jnp.asarray(mi), jnp.asarray(wog), jnp.asarray(jidx)))
    port = route_rows(torch.from_numpy(mask), torch.from_numpy(mi), torch.from_numpy(wog))
    assert_prefixes_equal(port, np.asarray(counts), np.asarray(r_mi),
                          np.asarray(r_j).astype(np.int32), np.asarray(r_wog))


@pytest.mark.parametrize("shape", [(1, 1), (5, 77), (9, 130)])
def test_k2_any_shape(shape):
    """The port takes shapes the TPU kernel refuses (R % 8, W % 128)."""
    mask, mi, wog = rows(0.4, True, shape, 7)
    port = route_rows(torch.from_numpy(mask), torch.from_numpy(mi), torch.from_numpy(wog))
    counts = mask.sum(axis=1)
    j_ref = np.zeros(shape, np.int32)
    mi_ref = np.zeros(shape, np.float32)
    wog_ref = np.zeros(shape, np.float32)
    for r in range(shape[0]):
        (cols,) = np.nonzero(mask[r])
        j_ref[r, :len(cols)] = cols
        mi_ref[r, :len(cols)] = mi[r, cols]
        wog_ref[r, :len(cols)] = wog[r, cols]
    assert_prefixes_equal(port, counts, mi_ref, j_ref, wog_ref)


def test_k2_rejects_other_devices():
    m = torch.zeros((8, 128), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        route_rows(m, torch.zeros((8, 128), device="meta"))
