"""The Alignment container — data model of an aligned dataset (a copy of
spydrpick_tpu/core/alignment.py; the port's functions read its fields
only, so an Alignment of either package serves them).

Re-designs the role of apegrunt's block-compressed
``Alignment_impl_block_compressed_storage`` (consumed by the reference
at include/SpydrPick.h:35-36, include/mi_parameters.hpp:48-59) as a
dense ``uint8`` code matrix plus derived per-column metadata.  On TPU
the compute kernels want a *dense one-hot tensor* feeding the MXU, not
run-length compression, so the canonical representation is:

  * ``codes``       — (n_samples, n_loci) uint8 state codes in host RAM,
  * ``translation`` — (n_loci,) int64 map filtered index -> original
                      genome position (apegrunt ``get_loci_translation``,
                      used at src/SpydrPick.cpp:228,472),
  * ``weights``     — (n_samples,) float64 sample weights
                      (apegrunt ``cache_sample_weights``,
                      src/SpydrPick.cpp:321),
  * per-column state presence/gap masks (apegrunt
    ``get_statepresence_blocks[_wo_gaps]`` / ``get_gappresence_blocks``,
    include/mi.hpp:64-68,114).

Device tensors (one-hot etc.) are materialised lazily by the engine.

The port adds one field, ``device_codes``: the same codes on the run's
card, uploaded once after the parse (``pipeline.load_and_preprocess``),
None on the CPU.  With it the counts come from the card
(``ops/columns.py:column_state_counts``), column and sample subsets are
taken there, and the host codes of a subset are made only when a host
reader (a side file, the outlier-node FASTA) reads ``codes``.  Every
function of the port that reads an alignment reads ``device_codes`` with
``getattr``, so an Alignment of the reference serves it too.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from spydrpick_torch.core.alphabet import GAP_STATE, N_STATES


@dataclasses.dataclass
class Alignment:
    codes: np.ndarray              # (n_samples, n_loci) uint8
    sample_names: list[str]
    id_string: str                 # alignment id (input file stem)
    translation: np.ndarray        # (n_loci,) int64, filtered -> original index
    n_original_positions: int      # original genome width (pre-filter / genome size)
    weights: np.ndarray | None = None  # (n_samples,) float64 sample weights
    # (n_samples, n_loci) uint8 copy of codes on the run's card, or None
    device_codes: torch.Tensor | None = None

    def __post_init__(self):
        assert self.codes.ndim == 2 and self.codes.dtype == np.uint8
        assert len(self.translation) == self.n_loci
        if self.device_codes is not None:
            assert tuple(self.device_codes.shape) == self.codes.shape

    def __getattr__(self, name):
        # reached only when ``codes`` is not yet made: a subset taken on the
        # card (``_deferred``) makes its host codes on the first read
        if name == "codes" and "_host_source" in self.__dict__:
            base, rows, cols = self.__dict__.pop("_host_source")
            c = base if rows is None else base[rows]
            self.codes = np.ascontiguousarray(c if cols is None else c[:, cols])
            return self.codes
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    # --- basic shape accessors (apegrunt Alignment::n_loci/size/effective_size,
    # call sites src/SpydrPick.cpp:187,255; include/mi.hpp:84,88) ---
    @property
    def n_samples(self) -> int:
        src = self.device_codes if self.device_codes is not None else self.codes
        return src.shape[0]

    @property
    def n_loci(self) -> int:
        src = self.device_codes if self.device_codes is not None else self.codes
        return src.shape[1]

    @property
    def effective_size(self) -> float:
        """Sum of sample weights (apegrunt ``effective_size``)."""
        w = self.weights if self.weights is not None else np.ones(self.n_samples)
        return float(np.sum(w))

    def size_string(self) -> str:
        """'<samples>x<loci>' used in output filenames (src/SpydrPick.cpp:429)."""
        return f"{self.n_samples}x{self.n_loci}"

    # --- per-column metadata ---
    @cached_property
    def column_counts(self) -> torch.Tensor:
        """(n_loci, 5) int32 unweighted per-column state counts on the
        codes' device: ``column_state_counts`` of ``device_codes`` (the
        kernel), or on the CPU its plain version over the host codes."""
        from spydrpick_torch.ops.columns import column_state_counts

        if self.device_codes is not None:
            return column_state_counts(self.device_codes)
        return column_state_counts(torch.from_numpy(np.ascontiguousarray(self.codes)))

    @cached_property
    def state_counts(self) -> np.ndarray:
        """(n_loci, 5) int64 unweighted per-column state counts (of
        ``column_counts``, fetched once)."""
        return self.column_counts.cpu().numpy().astype(np.int64)

    @cached_property
    def state_presence(self) -> np.ndarray:
        """(n_loci, 5) bool — which states occur in each column
        (apegrunt ``get_statepresence_blocks``)."""
        return self.state_counts > 0

    @cached_property
    def state_presence_wo_gaps(self) -> np.ndarray:
        """Presence mask with the gap state cleared
        (apegrunt ``get_statepresence_blocks_wo_gaps``, mi.hpp:114)."""
        p = self.state_presence.copy()
        p[:, GAP_STATE] = False
        return p

    @cached_property
    def gap_presence(self) -> np.ndarray:
        """(n_loci,) bool — column contains at least one gap
        (apegrunt ``get_gappresence_blocks``, mi.hpp:381)."""
        return self.state_presence[:, GAP_STATE]

    # --- subsetting (apegrunt subset/subsample, src/SpydrPick.cpp:207,269,315) ---
    def subset(self, keep: np.ndarray) -> "Alignment":
        """Column subset: ``keep`` is an array of filtered-column indices.
        With device codes the subset is taken on the card, its counts are
        the kept rows of this alignment's, and its host codes wait for a
        reader."""
        keep = np.asarray(keep, dtype=np.int64)
        fields = dict(sample_names=self.sample_names, id_string=self.id_string,
                      translation=self.translation[keep],
                      n_original_positions=self.n_original_positions, weights=self.weights)
        if self.device_codes is None:
            return Alignment(codes=np.ascontiguousarray(self.codes[:, keep]), **fields)
        idx = torch.from_numpy(keep).to(self.device_codes.device)
        out = self._deferred(self.device_codes.index_select(1, idx), None, keep, fields)
        if "column_counts" in self.__dict__:
            out.column_counts = self.column_counts.index_select(0, idx)
        return out

    def subsample(self, keep_samples: np.ndarray) -> "Alignment":
        """Row (sample) subset; with device codes taken on the card, its
        host codes waiting for a reader."""
        keep_samples = np.asarray(keep_samples, dtype=np.int64)
        fields = dict(sample_names=[self.sample_names[i] for i in keep_samples],
                      id_string=self.id_string, translation=self.translation,
                      n_original_positions=self.n_original_positions,
                      weights=self.weights[keep_samples] if self.weights is not None else None)
        if self.device_codes is None:
            return Alignment(codes=np.ascontiguousarray(self.codes[keep_samples, :]), **fields)
        idx = torch.from_numpy(keep_samples).to(self.device_codes.device)
        return self._deferred(self.device_codes.index_select(0, idx), keep_samples, None, fields)

    def _deferred(self, device_codes: torch.Tensor, rows, cols, fields: dict) -> "Alignment":
        """An Alignment of ``device_codes`` whose host codes are this one's
        ``rows`` and ``cols`` (None: all), made on the first read of
        ``codes``; the indices compose with this one's if its own are
        still to be made."""
        src = self.__dict__.get("_host_source")
        if src is None:
            base = self.codes
        else:
            base, r0, c0 = src
            rows = r0 if rows is None else (rows if r0 is None else r0[rows])
            cols = c0 if cols is None else (cols if c0 is None else c0[cols])
        out = object.__new__(Alignment)
        out.__dict__.update(fields, device_codes=device_codes, _host_source=(base, rows, cols))
        return out

    # --- statistics dump (apegrunt Alignment::statistics, SpydrPick.cpp:279) ---
    def statistics_string(self) -> str:
        """Multi-line alignment statistics (the role of apegrunt's
        ``Alignment::statistics(ostream)`` dumped by the reference when
        ``--output-state-frequencies`` is set, src/SpydrPick.cpp:275-282):
        shape, effective (weighted) size, overall and per-state symbol
        frequencies, gap occupancy, and the column allele-cardinality
        spectrum (how many columns are mono/bi/tri/quad/penta-state)."""
        counts = self.state_counts
        total = counts.sum()
        freqs = counts.sum(axis=0) / max(total, 1)
        n_states_per_col = self.state_presence.sum(axis=1)
        card = np.bincount(n_states_per_col, minlength=N_STATES + 1)
        gaps = counts[:, GAP_STATE].sum()
        cols_with_gaps = int(self.gap_presence.sum())
        lines = [
            f"alignment \"{self.id_string}\": {self.n_samples} samples x "
            f"{self.n_loci} loci ({self.n_original_positions} original positions)",
            f"effective (weighted) size: {self.effective_size:.2f}",
            "state frequencies: "
            + " ".join(f"{sym}={f:.4f}" for sym, f in zip("ACGT-", freqs)),
            f"gaps: {gaps} ({gaps / max(total, 1):.2%} of symbols); "
            f"{cols_with_gaps} of {self.n_loci} columns contain gaps",
            "column state cardinality: "
            + " ".join(f"{k}-state={int(card[k])}" for k in range(1, N_STATES + 1)),
        ]
        return "\n".join(lines)
