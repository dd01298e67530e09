"""Encoder/decoder table construction for the lane-format rANS engine.

Host-side (NumPy, vectorized) — tables are built once per block from the
rescaled frequency vector and uploaded to the device.  Equivalent of the
reference's table builders (ans_int.hpp:52-64 encoder entries,
ans_int.hpp:100-163 decoder slot table, ans_fold.hpp:193-204 precomputed
un-fold entries), re-laid-out as structure-of-arrays so device gathers
hit contiguous u32 vectors instead of packed structs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import A_KM_LOG2, A_MAX_FRAME_LOG2

# fmt A lower bound: state in [A_L, 256*A_L)
A_L = 1 << A_KM_LOG2


@dataclass(frozen=True)
class EncTable:
    """Per-symbol encode table (index = mapped symbol id)."""

    freq: np.ndarray  # u32 (sigma,)
    base: np.ndarray  # u32 (sigma,) cumulative freq
    ub: np.ndarray  # u32 (sigma,) renorm threshold 256*(L/M)*freq
    frame_size: int
    log2m: int


@dataclass(frozen=True)
class DecTable:
    """Per-slot decode table (index = state & (M-1)); SoA layout.

    Also carries the per-symbol inputs (nfreqs/sym_high/sym_nb) the
    per-slot arrays are expanded from.

    layout: the frequency-grouped slot layout (ops/grouped.GroupLayout)
    when the frame uses it (use_grouped_layout of the prelude freqs).
    The per-slot arrays may be None (slots=False): materialize_slots()
    fills them when a decoder is staged (they can be ~100MB for
    M = 2^22, so parsing a prelude does not build them).
    """

    freq: np.ndarray | None  # u32 (M,)
    offset: np.ndarray | None  # u32 (M,) slot - base[sym]
    sym: np.ndarray | None  # u32 (M,) owning symbol
    # fold/msb extensions (None for identity coders like ans_int):
    high: np.ndarray | None  # u32 (M,) reconstructed high part
    nb: np.ndarray | None  # u32 (M,) exception bytes to read
    frame_size: int
    log2m: int
    nfreqs: np.ndarray | None = None  # i64 (sigma,) scaled freqs
    sym_high: np.ndarray | None = None  # u32 (sigma,)
    sym_nb: np.ndarray | None = None  # u32 (sigma,)
    layout: object | None = None  # grouped.GroupLayout or None
    has_exc: bool = False


def _check_frame(M: int) -> int:
    if M & (M - 1):
        raise ValueError(f"frame size {M} not a power of two")
    log2m = M.bit_length() - 1
    if log2m > A_MAX_FRAME_LOG2:
        raise ValueError(
            f"frame 2**{log2m} exceeds the lane format's limit "
            f"2**{A_MAX_FRAME_LOG2}; for giant raw alphabets use the "
            f"compat engine (models.get(name, 'compat')), a folded coder "
            f"(ANSmsb/ANSfold), or pass max_frame to the codec")
    return log2m


def build_enc_table(nfreqs: np.ndarray, layout=None) -> EncTable:
    """layout: a grouped.GroupLayout — base values then follow the
    frequency-grouped slot order instead of the value-cumulative one
    (freq/ub are layout-independent)."""
    nf = np.asarray(nfreqs, dtype=np.uint64)
    M = int(nf.sum())
    log2m = _check_frame(M)
    if layout is not None:
        base = layout.base_of_symbol()
    else:
        base = np.concatenate(([0], np.cumsum(nf)[:-1])).astype(np.uint32)
    # 256 * (L/M) * freq; L/M = 2**(A_KM_LOG2 - log2m) is an exact integer
    k256 = np.uint64(1) << np.uint64(A_KM_LOG2 - log2m + 8)
    ub = (k256 * nf).astype(np.uint32)  # <= 2**31 * f / M <= 2**31, fits
    return EncTable(freq=nf.astype(np.uint32), base=base, ub=ub,
                    frame_size=M, log2m=log2m)


def build_dec_table(nfreqs: np.ndarray,
                    high_of_sym: np.ndarray | None = None,
                    nb_of_sym: np.ndarray | None = None,
                    layout=None, slots: bool = True) -> DecTable:
    """layout: grouped.GroupLayout — slots follow the frequency-grouped
    order.  slots=False skips the M-sized per-slot arrays
    (materialize_slots fills them when a decoder is staged)."""
    nf = np.asarray(nfreqs, dtype=np.int64)
    M = int(nf.sum())
    log2m = _check_frame(M)
    sym_high = sym_nb = None
    if high_of_sym is not None:
        sym_high = np.asarray(high_of_sym, dtype=np.uint32)
        sym_nb = np.asarray(nb_of_sym, dtype=np.uint32)
    dt = DecTable(freq=None, offset=None, sym=None, high=None, nb=None,
                  frame_size=M, log2m=log2m, nfreqs=nf,
                  sym_high=sym_high, sym_nb=sym_nb, layout=layout,
                  has_exc=high_of_sym is not None)
    return materialize_slots(dt) if slots else dt


def materialize_slots(dt: DecTable) -> DecTable:
    """Fill the M-sized per-slot arrays of a slim DecTable (no-op when
    already present).  With a grouped layout, slot order is rank-
    cumulative: symbol layout.perm[r] owns the r-th contiguous run."""
    if dt.freq is not None:
        return dt
    import dataclasses
    nf = dt.nfreqs
    if dt.layout is not None:
        order = dt.layout.perm.astype(np.int64)
    else:
        order = np.arange(len(nf), dtype=np.int64)
    f_run = nf[order]
    sym = np.repeat(order, f_run).astype(np.uint32)
    freq = np.repeat(f_run, f_run).astype(np.uint32)
    base_run = np.concatenate(([0], np.cumsum(f_run)[:-1]))
    offset = (np.arange(dt.frame_size, dtype=np.int64)
              - np.repeat(base_run, f_run)).astype(np.uint32)
    high = nb = None
    if dt.sym_high is not None:
        high = dt.sym_high[sym]
        nb = dt.sym_nb[sym]
    return dataclasses.replace(dt, freq=freq, offset=offset, sym=sym,
                               high=high, nb=nb)
