"""Tail-escape recoding: the huge-alphabet fast path for identity coders.

A huge live alphabet makes every sigma-sized decode table large (and
a decoder that scans per-symbol tables slow).  The reference C++ reads
its slot table with one cache load per symbol (ans_int.hpp:106-161).

This module shrinks the alphabet the decode loop sees by re-labelling
the frame's tail slots.  Rank symbols (frequency-sorted,
ties by value — the grouped layout's order) split at a cut K:

  * HOT ranks r < K keep their own frame slot run; the decoder's
    per-symbol table stores their full value (sym_high[r] = value,
    nb = 0).
  * TAIL ranks fold into escape symbols keyed by the value's high bits:
    esc_j aggregates every tail symbol with value >> 8*nb == h_j, its
    frame frequency is the SUM of their frequencies, and the value's
    low 8*nb bits travel as raw exception bytes (sym_high[esc_j] =
    h_j << 8*nb, sym_nb = nb) — exactly the machinery ans_msb already
    exercises (ans_msb.hpp:41-50 analogue), so the decoders handle the
    folded alphabet like any small one.

The folded frame is the SAME frame: hot slot runs plus merged tail runs
partition the original M slots, so the prelude (the true per-symbol
frequency vector) and the adjust_freqs search are untouched.  Both coder
sides derive the plan from the prelude frequencies alone
(plan_from_freqs is a pure function of nfreqs), so the wire needs no
extra header — like the grouped layout, the plan is format, not a knob
(docs/FORMAT.md fmt 2).

Compression effect, computed EXACTLY at build time from the frame
frequencies: a tail element of frequency f in escape bucket j costs
8*nb + log2(f / f_esc_j) extra bits.  The plan search admits a (K, nb)
pair only when the frequency-weighted total stays within
REL_LOSS_BUDGET of the frame cross-entropy; the delta is often
NEGATIVE for heavy-tailed data — adjust_freqs floors every live symbol
at frequency 1 (>= 1/M even when the true probability is far smaller),
while the merged escape frequency plus uniform low bits models the tail
mass jointly, so escaping can BEAT the reference's per-symbol frame.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# engage consideration only past this live-alphabet size — FORMAT
# CONSTANT (both coder sides derive the plan; see module docstring).
# Matches grouped.GROUPED_MIN_SIGMA.
ESCAPE_MIN_SIGMA = (1 << 13) + 1

# hot-cut candidates: the small cuts (2^10..2^13-ish) keep the folded
# alphabet at or below 2^13 symbols (including variants), and the plan
# key prefers smaller folded alphabets whenever the loss budget admits
# it (K=2^10 is loss-free on byte-aligned uniform tails and shrinks
# uniform-2^20's folded alphabet 4112 -> 1040); the larger cuts trade a
# grouped-layout folded alphabet for less escape loss on heavy-tailed
# data — FORMAT CONSTANTS
K_GRID = (1 << 10, 1 << 11, 1 << 12, (1 << 13) - (1 << 12) // 4,
          1 << 14, 1 << 15, 1 << 16)

# cap on escape variants (distinct tail high parts) — FORMAT CONSTANT
MAX_VARIANTS = 1 << 12

# admissible expected size loss as a fraction of the frame
# cross-entropy — FORMAT CONSTANT.  0.15% admits the paper's own
# large-alphabet shapes at n = 2^25 (zipf-2^20 +0.136%, uniform-2^20
# +0.139%, words49k +0.045%, uniform-2^16 +0.000% — frame-weighted;
# the data-weighted loss is lower still because adjust_freqs floors
# every live symbol at frequency 1 and the merged escape model does
# not), while mixed-frequency tails whose merge loss is real (the
# Jensen gap of log2 over the bucket) still decline and stay on the
# grouped layout.
REL_LOSS_BUDGET = 1.5e-3


@dataclass(frozen=True)
class EscapePlan:
    """Derived escape recoding (pure function of the prelude freqs)."""

    K: int                   # hot rank count
    nb: int                  # raw exception bytes per escape
    var_highs: np.ndarray    # i64 (V,) distinct tail value >> 8*nb, asc
    frame_freqs: np.ndarray  # i64 (K+V,) folded frame frequencies
    sym_high: np.ndarray     # u32 (K+V,) decoder value-high per symbol
    sym_nb: np.ndarray       # u32 (K+V,) exception bytes per symbol
    rank_of: np.ndarray      # u32 (len(nfreqs),) value -> rank (0 absent)
    loss_bits: float         # expected extra bits/element (can be < 0)
    sigma: int               # live alphabet size before folding

    @property
    def num_variants(self) -> int:
        return len(self.var_highs)

    def map_values(self, values: np.ndarray):
        """(mapped, k, b): folded symbol ids, per-element exception-byte
        counts, and the 3-wide lowest-first exception byte pool — the
        host-side twin of mappings_jax.msb_map_hist's contract."""
        v = np.ascontiguousarray(values, dtype=np.uint32)
        r = self.rank_of[v]
        hot = r < self.K
        vid = np.searchsorted(self.var_highs,
                              (v >> np.uint32(8 * self.nb)).astype(
                                  np.int64))
        mapped = np.where(hot, r,
                          np.uint32(self.K) + vid.astype(np.uint32))
        k = np.where(hot, np.uint32(0), np.uint32(self.nb))
        b = np.stack([(v & np.uint32(0xFF)).astype(np.uint8),
                      ((v >> np.uint32(8)) & np.uint32(0xFF)).astype(
                          np.uint8),
                      ((v >> np.uint32(16)) & np.uint32(0xFF)).astype(
                          np.uint8)], axis=-1)
        return mapped.astype(np.uint32), k.astype(np.uint32), b


def plan_from_freqs(nfreqs) -> EscapePlan | None:
    """Derive the escape plan from a frame frequency vector, or None
    when escaping is off (small alphabet, or no (K, nb) inside the loss
    budget).  Deterministic: float64 throughout, fixed evaluation order
    — both coder sides run this on the same prelude vector."""
    nf = np.asarray(nfreqs, dtype=np.int64)
    M = int(nf.sum())
    nz = np.flatnonzero(nf)
    sigma = int(len(nz))
    if sigma < ESCAPE_MIN_SIGMA:
        return None
    fz = nf[nz]
    # rank order: (freq desc, value asc) — identical to
    # grouped.build_group_layout (lexsort, last key primary)
    order = np.lexsort((nz, -fz))
    vals = nz[order]                       # i64 (sigma,) rank -> value
    fs = fz[order]                         # i64 (sigma,)
    p = fs.astype(np.float64) / M
    bits_true = -np.log2(p)
    budget = REL_LOSS_BUDGET * float((p * bits_true).sum())
    best_key, best = None, None
    for K in K_GRID:
        if K >= sigma:
            continue
        tv, tf, tp = vals[K:], fs[K:], p[K:]
        log2_tf = np.log2(tf.astype(np.float64))
        for nb in (1, 2, 3):
            highs = tv >> (8 * nb)
            var_highs, inv = np.unique(highs, return_inverse=True)
            V = len(var_highs)
            if V > MAX_VARIANTS:
                continue
            # exact: per-bucket freq sums are < 2^53 in float64
            fesc = np.bincount(inv, weights=tf.astype(np.float64)
                               ).astype(np.int64)
            delta = float((tp * (8.0 * nb + log2_tf
                                 - np.log2(fesc.astype(np.float64))[inv]
                                 )).sum())
            if delta > budget:
                continue
            # prefer small folded alphabets, but only coarsely:
            # compare sizes in 1024-symbol buckets and let the exact
            # loss break ties — keeps loss-free plans ahead of
            # marginally-smaller lossy ones (uniform-2^16: sigma'=1276
            # at +0.000% beats 1025 at +0.140%)
            key = ((K + V + 1023) // 1024, delta, K, nb)
            if best_key is None or key < best_key:
                best_key = key
                best = (K, nb, var_highs, fesc, delta)
    if best is None:
        return None
    K, nb, var_highs, fesc, delta = best
    frame_freqs = np.concatenate([fs[:K], fesc])
    sym_high = np.concatenate(
        [vals[:K].astype(np.uint32),
         (var_highs.astype(np.uint64) << np.uint64(8 * nb)).astype(
             np.uint32)])
    sym_nb = np.concatenate([np.zeros(K, np.uint32),
                             np.full(len(var_highs), nb, np.uint32)])
    rank_of = np.zeros(len(nf), dtype=np.uint32)
    rank_of[vals] = np.arange(sigma, dtype=np.uint32)
    return EscapePlan(K=K, nb=nb, var_highs=var_highs,
                      frame_freqs=frame_freqs, sym_high=sym_high,
                      sym_nb=sym_nb, rank_of=rank_of,
                      loss_bits=delta, sigma=sigma)
