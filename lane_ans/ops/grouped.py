"""Frequency-grouped slot layout: the large-alphabet frame order.

The lane format owns its slot layout — compression depends only on the
frequencies, and reference ans_int.hpp:52-64 builds value-cumulative
tables merely by convention.  For genuinely large alphabets (more than
GROUPED_MIN_SIGMA live symbols) the frame is laid out by frequency:

  * Present symbols are ranked by (frequency desc, value asc) and slots
    are assigned in rank order; symbols sharing one frequency value f
    form a GROUP occupying one contiguous slot range of count*f slots,
    laid out symbol-major (rank j within the group owns slots
    [g_slot0 + j*f, g_slot0 + (j+1)*f)).
  * Because the frequencies sum to M, the number of DISTINCT frequency
    values obeys NG*(NG+1)/2 <= M, i.e. NG <= sqrt(2M) <= 2896 for the
    format's largest frame 2^22 — a bound independent of sigma, which
    lets a decoder update states from NG-sized group tables alone.

The encoder's per-symbol bases follow this order (base_of_symbol); the
decoders read per-slot tables (tables.materialize_slots) built in the
same order.  Layout choice is a pure function of the prelude frequencies
(use_grouped_layout), so the decoder derives the encoder's layout from
the wire bytes with no extra header field (docs/FORMAT.md fmt 2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# live-symbol count from which the grouped layout is used — FORMAT
# CONSTANT: changing it changes which slot layout encoders emit
# (decoders re-derive it from nfreqs)
GROUPED_MIN_SIGMA = (1 << 13) + 1


def use_grouped_layout(nfreqs) -> bool:
    """Pure function of the prelude frequency vector (both coder sides
    must agree; see module docstring)."""
    nf = np.asarray(nfreqs)
    return int(np.count_nonzero(nf)) >= GROUPED_MIN_SIGMA


@dataclass(frozen=True)
class GroupLayout:
    """Host-side description of the frequency-grouped frame."""

    perm: np.ndarray        # u32 (sigma,) rank -> symbol id
    rank_of: np.ndarray     # u32 (len(nfreqs),) symbol id -> rank (0 if absent)
    g_f: np.ndarray         # u32 (NG,) frequency of each group
    g_rank0: np.ndarray     # u32 (NG,) first rank of each group
    g_slot0: np.ndarray     # u32 (NG,) first slot of each group
    sigma: int
    frame_size: int
    log2m: int

    @property
    def num_groups(self) -> int:
        return len(self.g_f)

    def base_of_symbol(self) -> np.ndarray:
        """Per-symbol-id slot base under this layout (sized like nfreqs;
        0 for absent symbols) — the encoder's base table."""
        sigma = self.sigma
        ranks = np.arange(sigma, dtype=np.int64)
        g = np.searchsorted(self.g_rank0, ranks, side="right") - 1
        base_rank = (self.g_slot0[g].astype(np.int64)
                     + (ranks - self.g_rank0[g]) * self.g_f[g])
        out = np.zeros(len(self.rank_of), dtype=np.uint32)
        out[self.perm] = base_rank.astype(np.uint32)
        return out


def build_group_layout(nfreqs) -> GroupLayout:
    nf = np.asarray(nfreqs, dtype=np.int64)
    M = int(nf.sum())
    if M & (M - 1):
        raise ValueError(f"frame size {M} not a power of two")
    log2m = M.bit_length() - 1
    nz = np.flatnonzero(nf)
    if len(nz) == 0:
        raise ValueError("empty frequency vector")
    fz = nf[nz]
    # rank order: (freq desc, symbol asc) — np.lexsort is stable with the
    # last key primary, so (-freq) primary breaks ties by the ascending
    # original order of nz
    order = np.lexsort((nz, -fz))
    perm = nz[order].astype(np.uint32)
    f_sorted = fz[order]
    rank_of = np.zeros(len(nf), dtype=np.uint32)
    rank_of[perm] = np.arange(len(perm), dtype=np.uint32)
    # group boundaries = runs of equal frequency in rank order
    starts = np.flatnonzero(np.diff(f_sorted, prepend=f_sorted[0] + 1))
    g_f = f_sorted[starts]
    g_rank0 = starts.astype(np.int64)
    counts = np.diff(np.append(starts, len(perm)))
    g_slot0 = np.concatenate(([0], np.cumsum(counts * g_f)[:-1]))
    return GroupLayout(
        perm=perm, rank_of=rank_of,
        g_f=g_f.astype(np.uint32), g_rank0=g_rank0.astype(np.uint32),
        g_slot0=g_slot0.astype(np.uint32), sigma=len(perm),
        frame_size=M, log2m=log2m)
