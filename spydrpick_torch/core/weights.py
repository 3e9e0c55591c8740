"""Population-structure sample reweighting (port of
spydrpick_tpu/core/weights.py:49-172).

Each sample's weight is ``1 / |{j : identity(i, j) >= threshold}|``, with
identity the fraction of identical (5-state) positions.  Sample-sample
identity counts are five per-state 0/1 matmuls over column tiles of the
codes, ``match = sum_s X_s X_s^T`` with ``X_s = (codes == s)``.

Exactness: the 0/1 products and their integer sums are exact in a float32
matmul while counts stay below 2^24 and TF32 is off (TF32 keeps ~10
mantissa bits and would round counts above 2^11; a bf16 matmul would
round them above 256).  One f32 accumulation run covers fewer than 2^24
columns; longer alignments flush partial counts into host float64 (exact
below 2^53), as the reference does.

The codes are read where they already are: an alignment with codes on
the device (``Alignment.device_codes``) is read there, any other is
uploaded for the products.
"""

from __future__ import annotations

import numpy as np
import torch

from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.core.alphabet import N_STATES
from spydrpick_torch.device import default_device

DEFAULT_REWEIGHTING_THRESHOLD = 0.9

_COL_TILE = 8192
# an f32 accumulator holds integer counts exactly only below 2^24
_EXACT_F32_COLS = 1 << 24


def _match_accum(sl: torch.Tensor, acc: torch.Tensor) -> None:
    """acc += per-state identity counts of one (S, ct) uint8 codes tile;
    pad code 255 matches no state."""
    for s in range(N_STATES):
        xs = (sl == s).to(torch.float32)
        acc.addmm_(xs, xs.T)


def sample_match_counts(alignment: Alignment, tile: int = _COL_TILE,
                        device: torch.device | None = None) -> np.ndarray:
    """(S, S) float64 matrix of identical-position counts between samples
    (gap == gap counts as a match), from the alignment's device codes when
    they lie on ``device``."""
    dev = default_device() if device is None else torch.device(device)
    # a float32 matmul must stay float32: TF32 would round the counts
    torch.backends.cuda.matmul.allow_tf32 = False
    codes_d = getattr(alignment, "device_codes", None)
    if codes_d is None or codes_d.device != dev:
        codes_d = torch.from_numpy(alignment.codes).to(dev)
    S, L = codes_d.shape
    ct = min(tile, max(((L + 127) // 128) * 128, 128))
    acc64 = np.zeros((S, S), np.float64)
    acc = torch.zeros((S, S), dtype=torch.float32, device=dev)
    group_cols = 0
    for c0 in range(0, L, ct):
        _match_accum(codes_d[:, c0:c0 + ct], acc)
        group_cols += ct
        if group_cols + ct > _EXACT_F32_COLS:
            # flush before the f32 counts could reach 2^24
            acc64 += acc.cpu().numpy().astype(np.float64)
            acc.zero_()
            group_cols = 0
    acc64 += acc.cpu().numpy().astype(np.float64)
    return acc64


def compute_sample_weights(alignment: Alignment,
                           threshold: float = DEFAULT_REWEIGHTING_THRESHOLD,
                           device: torch.device | None = None) -> np.ndarray:
    """(S,) float64 weights: 1 / cluster size at the identity threshold."""
    L = alignment.n_loci
    matches = sample_match_counts(alignment, device=device)
    similar = matches >= threshold * L
    cluster_sizes = similar.sum(axis=1)
    return 1.0 / cluster_sizes.astype(np.float64)


def hamming_distance_matrix(alignment: Alignment,
                            device: torch.device | None = None) -> np.ndarray:
    """(S, S) int64 Hamming distances (--output-sample-distance-matrix)."""
    matches = sample_match_counts(alignment, device=device)
    return (alignment.n_loci - matches).round().astype(np.int64)


def cache_sample_weights(alignment: Alignment, weights_file: str | None = None,
                         no_reweighting: bool = False,
                         threshold: float = DEFAULT_REWEIGHTING_THRESHOLD,
                         device: torch.device | None = None) -> Alignment:
    """Attach sample weights to the alignment.  Priority: explicit file
    (--sample-weights) > disabled (--no-sample-reweighting: all ones) >
    computed."""
    if weights_file is not None:
        from spydrpick_torch.io.loci import parse_value_list

        w = parse_value_list(weights_file)
        if len(w) != alignment.n_samples:
            raise ValueError(
                f"sample-weights file has {len(w)} values, alignment has "
                f"{alignment.n_samples} samples"
            )
    elif no_reweighting:
        w = np.ones(alignment.n_samples, dtype=np.float64)
    else:
        w = compute_sample_weights(alignment, threshold, device=device)
    alignment.weights = w
    return alignment
