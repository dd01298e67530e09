"""Semi-static model building: histogram rescaling + prelude wire format.

Bit-exact re-expression of the reference's model pipeline
(include/ans_util.hpp):
  * scale_freqs        (ans_util.hpp:77-95)  - one proportional rescale pass
  * adjust_freqs       (ans_util.hpp:100-157) - frame-size doubling search
  * serialize/load     (ans_util.hpp:25-63)  - vbyte | log2(M) | interp prelude

Floating-point operations replicate the reference's IEEE-double evaluation
order exactly (left-to-right accumulation, truncating double->int casts) so
the chosen frame sizes - and therefore compressed sizes - match the C++
implementation bit for bit.
"""

from __future__ import annotations

import math

import numpy as np

from . import interp, vbyte

try:  # optional C++ fast path (lane_ans/native); pure-Python fallback below
    from ..native import lib as _native
except Exception:  # pragma: no cover
    _native = None


def next_power_of_two(x: int) -> int:
    # reference: ans_util.hpp:65-72
    if x == 0:
        return 1
    return 1 << x.bit_length()


def is_power_of_two(x: int) -> bool:
    return x != 0 and (x & (x - 1)) == 0


def entropy_ordered(freqs, freq_sum: int) -> float:
    """H0 of a frequency vector, accumulated left-to-right in f64.

    reference: util.hpp:271-282. Summation order matters for bit-exactness.
    """
    if _native is not None:
        return _native.entropy_ordered(np.ascontiguousarray(freqs, np.uint64),
                                       freq_sum)
    h = 0.0
    n = float(freq_sum)
    freqs = np.asarray(freqs)
    # zeros contribute nothing; visiting only the nonzeros in index order
    # reproduces the C++ left-to-right accumulation exactly
    for f in freqs[np.flatnonzero(freqs)].tolist():
        p = f / n
        h += p * math.log2(p)
    return -h


def cross_entropy_ordered(P, Q) -> float:
    """Cross entropy between two freq vectors (util.hpp:284-298)."""
    if _native is not None:
        return _native.cross_entropy_ordered(
            np.ascontiguousarray(P, np.uint64), np.ascontiguousarray(Q, np.uint32))
    P = np.asarray(P)
    Q = np.asarray(Q)
    n = float(int(P.sum()))
    m = float(int(Q.sum()))
    k = min(len(P), len(Q))
    both = np.flatnonzero((P[:k] != 0) & (Q[:k] != 0))
    h = 0.0
    for p_, q_ in zip(P[both].tolist(), Q[both].tolist()):
        h += (p_ / n) * math.log2(q_ / m)
    return -h


def scale_freqs(S, F, mapping, M: int, sigma: int, freq_sum: int) -> bool:
    """One rescale pass onto frame size M; True means "retry with larger M".

    reference: ans_util.hpp:77-95.  S is mutated in place.  Symbols are
    visited in increasing-frequency order (mapping); the running ratio
    M/freq_sum adapts so the final symbol absorbs the remainder exactly.
    """
    if _native is not None:
        return _native.scale_freqs(S, F, mapping, M, sigma, freq_sum)
    M = int(M)
    freq_sum = int(freq_sum)
    for cur in range(sigma):
        m = mapping[cur]
        f = int(F[m])
        aratio = M / freq_sum  # f64, recomputed with the shrinking totals
        s = int(0.5 + aratio * f)  # C++ (uint32_t)(...) truncation
        if s == 0:
            s = 1
        S[m] = s
        M -= s
        freq_sum -= f
        if M < 0:
            break
    return M != 0


def adjust_freqs(freqs, largest_sym: int, require_u16: bool,
                 H_approx: int = 1,
                 max_frame: int | None = None) -> np.ndarray:
    """Frame-size search: smallest power-of-two frame whose cross entropy is
    within H_approx/1000 of H0.

    reference: ans_util.hpp:100-157.  Returns scaled freqs (0 for absent
    symbols) of length largest_sym+1; their sum is the (power-of-two) frame.

    max_frame (lane_ans extension, None = reference behavior): stop the
    doubling search at this frame size even if the entropy target is not
    met — the decode tables are frame-sized, so lane codecs trade ~0.1-0.4% compression for a much smaller table
    (docs/FORMAT.md).  The frame never goes below next_pow2(sigma).
    """
    freqs = np.asarray(freqs, dtype=np.uint64)
    nz = np.flatnonzero(freqs)
    sigma = int(nz.size)
    freq_sum = int(freqs.sum())
    if sigma == 0:
        # the doubling search never terminates on an all-zero histogram
        raise ValueError("cannot build a model from an all-zero "
                         "histogram (empty input?)")
    target = sigma
    if not is_power_of_two(target):
        target = next_power_of_two(target)

    # increasing (freq, sym) order; ties by symbol id (std::sort on pairs)
    order = sorted(((int(freqs[i]), int(i)) for i in nz))
    mapping = np.fromiter((s for _, s in order), dtype=np.int64, count=sigma)

    H = entropy_ordered(freqs, freq_sum)
    scaled = np.zeros(largest_sym + 1, dtype=np.uint32)
    prev = np.zeros(largest_sym + 1, dtype=np.uint32)
    threshold = H * (1.0 + H_approx / 1000.0)
    while True:
        if scale_freqs(scaled, freqs, mapping, target, sigma, freq_sum):
            target *= 2
            continue
        max_norm = int(scaled.max())
        XH = cross_entropy_ordered(freqs, scaled)
        if require_u16 and max_norm >= 0xFFFF:
            scaled = prev.copy()
            break
        # XH == 0.0 guard: for degenerate inputs (single distinct symbol)
        # H == XH == threshold == 0 and the reference loops forever
        # (ans_util.hpp:149 never fires); we accept the exact model instead.
        if XH < threshold or XH == 0.0:
            break
        if max_frame is not None and target >= max_frame:
            break
        target *= 2
        prev = scaled.copy()
    return scaled


def serialize_prelude(nfreqs, frame_size: int) -> bytes:
    """vbyte(max_sym) | u8 log2(M) | interp(cumulative freqs+1).

    reference: ans_util.hpp:46-63.  The interp payload codes the strictly
    increasing sequence B[s] = sum_{t<=s}(freq[t]+1) over universe
    frame_size + (max_sym+1) + 1.
    """
    nfreqs = np.asarray(nfreqs)
    max_sym = len(nfreqs) - 1
    out = bytearray(vbyte.encode_u32(max_sym))
    out.append(int(math.log2(frame_size)))
    # single-pass u64 cumsum; nfreqs+1 stays in the input dtype (< 2^32)
    increasing = np.cumsum(nfreqs + np.uint32(1), dtype=np.uint64) - 1
    out += interp.encode(increasing, len(nfreqs), frame_size + len(nfreqs) + 1)
    return bytes(out)


def load_prelude(buf: bytes):
    """Inverse of serialize_prelude; returns (nfreqs u32 array, byte_len).

    reference: ans_util.hpp:25-42 (the reference never needs byte_len; we
    return the number of bytes the prelude logically occupies = header +
    consumed u32 words, handy for stream framing).
    """
    max_sym, pos = vbyte.decode_u32(buf, 0)
    frame_size = 1 << buf[pos]
    pos += 1
    n = max_sym + 1
    vals, words = interp.decode(buf, n, frame_size + n + 1, bit_offset=pos * 8)
    vals = np.asarray(vals, dtype=np.uint64)
    nfreqs = np.empty(n, dtype=np.uint32)
    nfreqs[0] = vals[0]
    if n > 1:
        nfreqs[1:] = (np.diff(vals) - 1).astype(np.uint32)
    return nfreqs, pos + words * 4
