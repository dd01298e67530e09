"""Reference-wire-format rANS codecs (NumPy/Python golden model).

This module is the framework's *oracle*: a behavioral re-expression of the
reference's six large-alphabet rANS coders plus the byte coder, producing
byte-identical compressed streams (modulo the reference's uninitialized
prelude padding bits, which we zero).  It is intentionally sequential and
simple; the device lane codecs (lane_ans.ops) are validated against it.

Shared mechanics (reference: ans_int.hpp:38-306 as exemplar):
  * state is u64, lower bound L = K * frame_size, K = 16
  * encode_symbol: renormalize (emit low 32 bits) when
    state >= K * 2**32 * freq, then state = (state/f)*M + state%f + base
  * streams are encoded in reverse index order, round-robin over 4
    interleaved states, with n mod 4 leftovers peeled into state 0 first
  * decode pops the 4 flushed u64 final states from the stream end and emits
    forward, reading renorm words / exception bytes backwards (LIFO)
"""

from __future__ import annotations

import numpy as np

from ..constants import (K, MSB_MAX_SIGMA, RADIX, fold_max_sigma,
                         fold_threshold)
from . import mappings, model
from .model import adjust_freqs, load_prelude, serialize_prelude

try:  # optional C++ fast path (lane_ans/native); pure-Python fallback below
    from ..native import lib as _native
except Exception:  # pragma: no cover
    _native = None

NUM_STATES = 4


# --------------------------------------------------------------------------
# generic interleaved engine
# --------------------------------------------------------------------------

def _enc_tables(nfreqs):
    """Python-int tables: (freq, base, sym_upper_bound) per symbol."""
    freq = [int(f) for f in nfreqs]
    base = [0] * len(freq)
    acc = 0
    for i, f in enumerate(freq):
        base[i] = acc
        acc += f
    kr = K * RADIX
    sub = [kr * f for f in freq]
    return freq, base, sub


def _state_index_iter(n: int):
    """Yields (position, state_idx) in reference encode order
    (ans_int.hpp:226-241): positions n-1..0; first n%4 go to state 0,
    the rest cycle 0,1,2,3."""
    r = n % NUM_STATES
    for j in range(n):
        p = n - 1 - j
        sidx = 0 if j < r else (j - r) % NUM_STATES
        yield p, sidx


def interleaved_encode(mapped, nfreqs, frame_size: int,
                       exc_counts=None, exc_bytes=None) -> bytes:
    """Encode mapped symbols with the 4-state shared-stream discipline.

    exc_counts/exc_bytes: optional per-position exception bytes (emitted
    before the symbol's renorm word, lowest byte first), as produced by
    mappings.fold_exceptions.
    """
    if _native is not None:
        nf = np.ascontiguousarray(nfreqs, np.uint32)
        base = np.concatenate(([0], np.cumsum(nf.astype(np.uint64))[:-1])
                              ).astype(np.uint32)
        ec = (np.ascontiguousarray(exc_counts, np.uint8)
              if exc_counts is not None else None)
        eb = (np.ascontiguousarray(exc_bytes, np.uint8)
              if exc_bytes is not None else None)
        return _native.compat_encode(
            np.ascontiguousarray(mapped, np.uint32), ec, eb, nf, base,
            int(frame_size))
    freq_l, base_l, sub_l = _enc_tables(nfreqs)
    M = int(frame_size)
    L = K * M
    out = bytearray()
    states = [L] * NUM_STATES
    mapped_l = mapped.tolist()
    exc_l = exc_counts.tolist() if exc_counts is not None else None
    for p, sidx in _state_index_iter(len(mapped_l)):
        if exc_l is not None:
            k = exc_l[p]
            if k:
                out += exc_bytes[p, :k].tobytes()
        s = mapped_l[p]
        st = states[sidx]
        if st >= sub_l[s]:
            out += (st & 0xFFFFFFFF).to_bytes(4, "little")
            st >>= 32
        f = freq_l[s]
        states[sidx] = (st // f) * M + (st % f) + base_l[s]
    for i in range(NUM_STATES):
        out += (states[i] - L).to_bytes(8, "little")
    return bytes(out)


def _dec_tables(nfreqs):
    """Per-slot arrays: (freq_of_slot, offset_of_slot, sym_of_slot)."""
    nf = np.asarray(nfreqs, dtype=np.int64)
    sym_slot = np.repeat(np.arange(len(nf), dtype=np.int64), nf)
    freq_slot = np.repeat(nf, nf)
    base = np.concatenate(([0], np.cumsum(nf)[:-1]))
    offset_slot = np.arange(nf.sum(), dtype=np.int64) - base[sym_slot]
    return freq_slot, offset_slot, sym_slot


def interleaved_decode(buf: bytes, n: int, nfreqs, high_of_sym=None,
                       nb_of_sym=None):
    """Decode n symbols from the stream end backwards.

    high_of_sym/nb_of_sym: optional per-symbol reconstruction arrays for
    fold/msb coders (exception bytes are re-read LIFO and merged as the
    little-endian low part); identity coders emit the slot symbol.
    Returns a uint32 array.
    """
    freq_slot, offset_slot, sym_slot = _dec_tables(nfreqs)
    M_chk = int(np.asarray(nfreqs, dtype=np.int64).sum())
    if M_chk <= 0 or (M_chk & (M_chk - 1)):
        # all-zero or non-pow2 frame: a well-formed prelude can still
        # carry it (diffs of 1 -> every freq 0); the state & (M-1) mask
        # would index garbage (native twin rejects identically)
        raise ValueError(f"corrupt prelude: frame size {M_chk} is not a "
                         "positive power of two")
    if _native is not None:
        high_slot = nb_slot = None
        if high_of_sym is not None:
            high_slot = np.ascontiguousarray(
                np.asarray(high_of_sym, np.uint32)[sym_slot])
            nb_slot = np.ascontiguousarray(
                np.asarray(nb_of_sym, np.uint8)[sym_slot])
        return _native.compat_decode(
            buf, n, freq_slot.astype(np.uint32),
            offset_slot.astype(np.uint32), sym_slot.astype(np.uint32),
            int(np.asarray(nfreqs, dtype=np.int64).sum()),
            high_slot, nb_slot)
    undo = (None if high_of_sym is None
            else _make_fold_undo(buf, np.asarray(high_of_sym),
                                 np.asarray(nb_of_sym)))
    M = int(np.asarray(nfreqs, dtype=np.int64).sum())
    mask = M - 1
    log2M = M.bit_length() - 1
    L = K * M
    cur = len(buf)
    states = [0] * NUM_STATES
    # last flushed u64 is popped first and decodes output position 0
    for i in range(NUM_STATES):
        cur -= 8
        states[i] = int.from_bytes(buf[cur : cur + 8], "little") + L
    out = np.zeros(n, dtype=np.uint32)
    fs = freq_slot.tolist()
    os_ = offset_slot.tolist()
    ss = sym_slot.tolist()
    fast = n - (n % NUM_STATES)
    for i in range(n):
        sidx = (i % NUM_STATES) if i < fast else NUM_STATES - 1
        st = states[sidx]
        slot = st & mask
        st = fs[slot] * (st >> log2M) + os_[slot]
        if st < L:
            cur -= 4
            st = (st << 32) | int.from_bytes(buf[cur : cur + 4], "little")
        states[sidx] = st
        sym = ss[slot]
        if undo is None:
            out[i] = sym
        else:
            out[i], cur = undo(sym, cur)
    return out


def _make_fold_undo(buf, high_of_sym, nb_of_sym):
    """LIFO exception-byte merge (ans_fold.hpp:135-147): read nb stripped
    low bytes walking backwards; they were emitted lowest-byte-first so the
    backward window [cur-nb, cur) is the little-endian low part."""
    high_l = high_of_sym.tolist()
    nb_l = nb_of_sym.tolist()

    def undo(sym, cur):
        nb = nb_l[sym]
        if nb:
            cur -= nb
            low = int.from_bytes(buf[cur : cur + nb], "little")
            return high_l[sym] + low, cur
        return high_l[sym], cur

    return undo


# --------------------------------------------------------------------------
# method implementations (encode(values)->bytes, decode(buf,n)->values)
# --------------------------------------------------------------------------

def _hist(mapped, minlength):
    # bincount yields int64; counts are nonnegative, so the u64 view is
    # free (avoids a giant-alphabet copy)
    return np.bincount(mapped, minlength=minlength).view(np.uint64)


class AnsInt:
    """Large-alphabet rANS over raw u32 symbols (reference: ans_int.hpp)."""

    name = "ANS"
    require_u16 = False

    def __init__(self, h_approx: int = 1):
        self.h_approx = h_approx

    def encode(self, values) -> bytes:
        values = np.asarray(values, dtype=np.uint32)
        max_sym = int(values.max()) if len(values) else 0
        freqs = _hist(values, max_sym + 1)
        nfreqs = adjust_freqs(freqs, max_sym, False, self.h_approx)
        M = int(nfreqs.sum())
        prelude = serialize_prelude(nfreqs, M)
        return prelude + interleaved_encode(values, nfreqs, M)

    def decode(self, buf: bytes, n: int):
        nfreqs, _ = load_prelude(buf)
        return interleaved_decode(buf, n, nfreqs)


class AnsSint(AnsInt):
    name = "ANSsint"

    def __init__(self, h_approx: int):
        super().__init__(h_approx)
        self.name = f"ANSsint-{h_approx}"


class AnsMsb:
    """Magnitude-bucketed rANS (reference: ans_msb.hpp)."""

    name = "ANSmsb"

    def __init__(self, h_approx: int = 1):
        self.h_approx = h_approx

    def _map(self, values):
        mapped = mappings.msb_map(values)
        k = mappings.msb_exception_bytes(mapped)
        b = np.empty(values.shape + (3,), dtype=np.uint8)
        b[..., 0] = (values & np.uint32(0xFF)).astype(np.uint8)
        b[..., 1] = ((values >> np.uint32(8)) & np.uint32(0xFF)).astype(np.uint8)
        b[..., 2] = ((values >> np.uint32(16)) & np.uint32(0xFF)).astype(np.uint8)
        return mapped, k, b

    def encode(self, values) -> bytes:
        values = np.asarray(values, dtype=np.uint32)
        mapped, k, b = self._map(values)
        max_sym = int(mapped.max())
        freqs = _hist(mapped, MSB_MAX_SIGMA)
        nfreqs = adjust_freqs(freqs, max_sym, True, self.h_approx)
        M = int(nfreqs.sum())
        prelude = serialize_prelude(nfreqs, M)
        return prelude + interleaved_encode(mapped, nfreqs, M, k, b)

    def decode(self, buf: bytes, n: int):
        nfreqs, _ = load_prelude(buf)
        syms = np.arange(len(nfreqs), dtype=np.uint32)
        high = mappings.msb_unmap_high(syms)
        nb = mappings.msb_exception_bytes(syms)
        return interleaved_decode(buf, n, nfreqs, high, nb)


class AnsSmsb(AnsMsb):
    def __init__(self, h_approx: int):
        super().__init__(h_approx)
        self.name = f"ANSsmsb-{h_approx}"


class AnsFold:
    """Generalized byte-fold rANS, fidelity 1..8 (reference: ans_fold.hpp)."""

    def __init__(self, fidelity: int, h_approx: int = 1):
        assert 1 <= fidelity <= 8
        self.fidelity = fidelity
        self.h_approx = h_approx
        self.name = f"ANSfold-{fidelity}"

    def encode(self, values) -> bytes:
        values = np.asarray(values, dtype=np.uint32)
        mapped = mappings.fold_map(values, self.fidelity)
        k, b = mappings.fold_exceptions(values, self.fidelity)
        max_sym = int(mapped.max())
        freqs = _hist(mapped, fold_max_sigma(self.fidelity))
        nfreqs = adjust_freqs(freqs, max_sym, True, self.h_approx)
        M = int(nfreqs.sum())
        prelude = serialize_prelude(nfreqs, M)
        return prelude + interleaved_encode(mapped, nfreqs, M, k, b)

    def decode(self, buf: bytes, n: int):
        nfreqs, _ = load_prelude(buf)
        syms = np.arange(len(nfreqs), dtype=np.uint32)
        high, nb = mappings.fold_unmap_high(syms, self.fidelity)
        return interleaved_decode(buf, n, nfreqs, high, nb)


class AnsReorderFold:
    """Fold + most-frequent-symbol remap (reference: ans_reorder_fold.hpp).

    Deviation from the reference: in identity mode (sigma < 2**(fidelity+7))
    the reference decoder subtracts `thres` even from values that were
    folded, which breaks round-trips for inputs that mix a small alphabet
    with values >= thres (ans_reorder_fold.hpp:288-302).  We decode those
    correctly; encoded bytes are unchanged.
    """

    def __init__(self, fidelity: int, h_approx: int = 1):
        self.fidelity = fidelity
        self.h_approx = h_approx
        self.name = f"ANSrfold-{fidelity}"

    def encode(self, values) -> bytes:
        values = np.asarray(values, dtype=np.uint32)
        f = self.fidelity
        remapped, header = mappings.craft_reorder(values, f)
        mapped = mappings.fold_map(remapped, f)
        k, b = mappings.fold_exceptions(remapped, f)
        max_sym = int(mapped.max())
        freqs = _hist(mapped, fold_max_sigma(f))
        nfreqs = adjust_freqs(freqs, max_sym, True, self.h_approx)
        M = int(nfreqs.sum())
        prelude = serialize_prelude(nfreqs, M)
        return bytes(header) + prelude + interleaved_encode(
            mapped, nfreqs, M, k, b)

    def decode(self, buf: bytes, n: int):
        f = self.fidelity
        thres = fold_threshold(f)
        do_reorder = int.from_bytes(buf[0:4], "little")
        pos = 4
        if do_reorder == 1:
            mf = np.frombuffer(buf[pos : pos + 4 * thres], dtype="<u4")
            pos += 4 * thres
        else:
            mf = np.arange(thres, dtype=np.uint32)
        nfreqs, _ = load_prelude(buf[pos:])
        syms = np.arange(len(nfreqs), dtype=np.uint32)
        high, nb = mappings.fold_unmap_high(syms, f)
        if do_reorder == 1:
            # unfolded ids < thres are ranks into the most-frequent table;
            # folded values carry mapping[x] = x + thres -> subtract it back
            high = np.where(syms < thres, mf[np.minimum(syms, thres - 1)],
                            high - np.uint32(thres)).astype(np.uint32)
        else:
            high = np.where(syms < thres, syms, high).astype(np.uint32)
        return interleaved_decode(buf, n, nfreqs, high, nb)


# --------------------------------------------------------------------------
# byte coder (entropy backend of vbyteANS / streamvbyteANS)
# --------------------------------------------------------------------------

def byte_prelude_encode(freqs):
    """Normalize a 256-bin histogram and interp-code the cumulative
    prelude (layout of ans_byte.hpp: raw interp over universe
    MAX_FRAME_SIZE + 256).  THE one implementation shared by every
    byte-entropy stage (compat ansbyte, lane ansbyte, tansbyte) — the
    prelude bytes are wire format.  Returns (prelude bytes, nfreqs)."""
    from ..constants import BYTE_MAX_FRAME_SIZE, BYTE_MAX_SIGMA
    from . import interp
    nfreqs = byte_adjust_freqs(freqs)
    increasing = np.cumsum(nfreqs.astype(np.uint64) + 1) - 1
    return interp.encode(increasing, BYTE_MAX_SIGMA,
                         BYTE_MAX_FRAME_SIZE + BYTE_MAX_SIGMA), nfreqs


def byte_prelude_decode(buf: bytes):
    """Inverse of byte_prelude_encode: (nfreqs i64 (256,), byte offset
    past the prelude)."""
    from ..constants import BYTE_MAX_FRAME_SIZE, BYTE_MAX_SIGMA
    from . import interp
    vals, words = interp.decode(buf, BYTE_MAX_SIGMA,
                                BYTE_MAX_FRAME_SIZE + BYTE_MAX_SIGMA)
    vals = np.asarray(vals, dtype=np.int64)
    # diff over a prepended -1 inverts cumsum(nfreqs + 1) - 1 at every
    # index, including 0
    nfreqs = np.diff(np.concatenate(([-1], vals))) - 1
    return nfreqs, words * 4


def byte_adjust_freqs(freqs):
    """256-symbol normalizer (reference: ans_byte.hpp:40-97)."""
    from ..constants import (BYTE_FRAME_FACTOR, BYTE_MAX_FRAME_SIZE,
                             BYTE_MAX_SIGMA)
    freqs = np.asarray(freqs, dtype=np.uint64)
    adj = np.zeros(BYTE_MAX_SIGMA, dtype=np.int64)
    uniq = int((freqs != 0).sum())
    initial_sum = int(freqs.sum())
    target = uniq * BYTE_FRAME_FACTOR
    if target > BYTE_MAX_FRAME_SIZE:
        target = BYTE_MAX_FRAME_SIZE
    if not model.is_power_of_two(target):
        target = model.next_power_of_two(target)
    c = target / initial_sum
    cur = 1 << 62
    fudge = 1.0
    freqs_l = freqs.tolist()
    while cur > target:
        fudge -= 0.01
        cur = 0
        for sym in range(BYTE_MAX_SIGMA):
            v = int(fudge * float(freqs_l[sym]) * c)
            if v == 0 and freqs_l[sym] != 0:
                v = 1
            adj[sym] = v
            cur += v
    excess = target - cur
    for i in range(BYTE_MAX_SIGMA):
        sym = BYTE_MAX_SIGMA - i - 1
        ncnt = int(adj[sym])
        if ncnt == 0:
            continue
        ratio = excess / cur
        adder = int(ratio * ncnt)
        if adder > excess:
            adder = excess
        excess -= adder
        cur -= ncnt
        adj[sym] += adder
    if excess != 0:
        adj[int(np.argmax(adj))] += excess
    return adj.astype(np.uint32)


class AnsByte:
    """rANS over the byte alphabet (reference: ans_byte.hpp:99-300).

    The prelude is a raw interp code of the 256 cumulative freqs over the
    fixed universe MAX_FRAME_SIZE + 256 (no vbyte/log2 header).
    """

    name = "ansbyte"

    def encode(self, data: bytes) -> bytes:
        from ..constants import BYTE_MAX_FRAME_SIZE, BYTE_MAX_SIGMA
        from . import interp
        from .. import native
        arr = np.frombuffer(data, dtype=np.uint8)
        freqs = native.byte_histogram(arr)
        prelude, nfreqs = byte_prelude_encode(freqs)
        M = int(nfreqs.sum())
        return prelude + interleaved_encode(arr.astype(np.uint32), nfreqs, M)

    def decode(self, buf: bytes, n: int) -> bytes:
        nfreqs, _ = byte_prelude_decode(buf)
        out = interleaved_decode(buf, n, nfreqs.astype(np.uint32))
        return out.astype(np.uint8).tobytes()
