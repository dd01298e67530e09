"""Primitive-layer property tests.

Ports of the reference's unbuilt test harnesses (SURVEY.md section 4):
  * src/test.cpp:49-72 — fold mapping inverse property (vectorized
    random + boundary sweep instead of the 2^32 exhaustive loop)
  * src/interp_test.cpp:134-253 — clustered-sequence round-trip of the
    recursive interpolative coder
plus vbyte and BWT/MTF primitives.
"""

import numpy as np
import pytest

from lane_ans.reference_model import interp, mappings, vbyte
from lane_ans.utils import bwt


@pytest.mark.parametrize("fidelity", list(range(1, 9)))
def test_fold_inverse_property(fidelity):
    """undo(fold(x)) == x with the dropped bytes restored
    (reference src/test.cpp checks all 2^32; we sweep boundaries +
    a large random sample)."""
    rng = np.random.default_rng(fidelity)
    thres = 1 << (fidelity + 7)
    edges = []
    for p in [0, 1, thres - 1, thres, thres + 1, (1 << 16) - 1, 1 << 16,
              (1 << 24) - 1, 1 << 24, (1 << 32) - 1, (1 << 30),
              (1 << 30) - 1]:
        edges.append(p)
    x = np.concatenate([
        np.array(edges, dtype=np.uint32),
        rng.integers(0, 1 << 32, size=2_000_000, dtype=np.uint32),
    ])
    sym = mappings.fold_map(x, fidelity)
    k, b = mappings.fold_exceptions(x, fidelity)
    high, nb = mappings.fold_unmap_high(sym, fidelity)
    np.testing.assert_array_equal(k, nb)
    # reassemble: high + little-endian low bytes
    low = np.zeros(len(x), dtype=np.uint64)
    for j in range(3):
        low += np.where(j < k, b[:, j].astype(np.uint64) << (8 * j), 0)
    np.testing.assert_array_equal(
        (high.astype(np.uint64) + low).astype(np.uint32), x)


def test_msb_inverse_property():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0, 1, 255, 256, 257, (1 << 16) - 1, 1 << 16,
                  (1 << 16) + 1, (1 << 24) - 1, 1 << 24, (1 << 24) + 1,
                  (1 << 32) - 1], dtype=np.uint32),
        rng.integers(0, 1 << 32, size=2_000_000, dtype=np.uint32),
    ])
    sym = mappings.msb_map(x)
    k = mappings.msb_exception_bytes(sym)
    high = mappings.msb_unmap_high(sym)
    low = np.zeros(len(x), dtype=np.uint64)
    for j in range(3):
        low += np.where(j < k, ((x >> np.uint32(8 * j)) & np.uint32(0xFF))
                        .astype(np.uint64) << (8 * j), 0)
    np.testing.assert_array_equal(
        (high.astype(np.uint64) + low).astype(np.uint32), x)


def _clustered(rng, n, u):
    """Clustered docid-like increasing sequence
    (reference src/interp_test.cpp:134-166: geometric gaps with rare
    large jumps)."""
    gaps = rng.geometric(0.3, size=n).astype(np.int64)
    jumps = rng.random(n) < 0.001
    gaps[jumps] += rng.integers(100, 10000, size=int(jumps.sum()))
    seq = np.cumsum(gaps)
    return (seq * (u - 1) // max(1, int(seq[-1]))).astype(np.uint64)


def test_interp_clustered_roundtrip():
    rng = np.random.default_rng(7)
    n = 100_000
    u = 1 << 27
    seq = np.unique(_clustered(rng, n, u))
    blob = interp.encode(seq, len(seq), u)
    out, _ = interp.decode(blob + b"\0" * 8, len(seq), u)
    np.testing.assert_array_equal(np.asarray(out, dtype=np.uint64), seq)


def test_interp_dense_roundtrip():
    seq = np.arange(1000, dtype=np.uint64) * 3
    blob = interp.encode(seq, len(seq), 3000)
    out, _ = interp.decode(blob + b"\0" * 8, len(seq), 3000)
    np.testing.assert_array_equal(np.asarray(out, dtype=np.uint64), seq)


def test_vbyte_scalar_roundtrip():
    for v in [0, 1, 127, 128, 16383, 16384, (1 << 32) - 1]:
        blob = vbyte.encode_u32(v)
        out, pos = vbyte.decode_u32(blob, 0)
        assert out == v and pos == len(blob)


def test_bwt_mtf_roundtrip():
    rng = np.random.default_rng(1)
    s = rng.integers(0, 40, size=3000).astype(np.uint32)
    t, _ = bwt.bwt(s)
    ranks = bwt.mtf(t, 40)
    np.testing.assert_array_equal(bwt.mtf_inverse(ranks, 40), t)


def test_suffix_array_correct():
    rng = np.random.default_rng(2)
    s = rng.integers(0, 4, size=500)
    sa = bwt.suffix_array(s)
    naive = sorted(range(len(s)), key=lambda i: tuple(s[i:]))
    np.testing.assert_array_equal(sa, naive)


def test_mtf_rejects_out_of_range_sigma():
    """Explicit sigma smaller than the alphabet must raise, not write
    out of bounds in the native backend (regression)."""
    import pytest
    with pytest.raises((ValueError, KeyError)):
        bwt.mtf(np.array([5], dtype=np.uint32), sigma=3)


def test_bwt_empty_raises():
    import pytest
    with pytest.raises(ValueError):
        bwt.bwt(np.empty(0, dtype=np.uint8))


def test_arith_scale_counts_heavy_hitter_fast():
    """One dominant symbol + tens of thousands of singletons hung the
    old one-unit-at-a-time correction loop (regression: now O(sigma
    log sigma) waterfill)."""
    import time
    from lane_ans.models.arith import _scale_counts
    counts = np.concatenate([[10_000_000], np.ones(60_000)]).astype(
        np.int64)
    t0 = time.perf_counter()
    s = _scale_counts(counts, 17)
    assert time.perf_counter() - t0 < 2.0
    assert int(s.sum()) == 1 << 17 and int(s.min()) >= 1


def test_adjust_freqs_rejects_all_zero_histogram():
    """The frame-doubling search never terminates on a zero histogram
    (regression: pure-python hung, native wrapped through c_int64)."""
    import pytest
    from lane_ans.reference_model import model
    with pytest.raises(ValueError, match="all-zero"):
        model.adjust_freqs(np.zeros(4, np.uint64), 3, False)


def test_native_compat_decode_rejects_zero_frame_prelude():
    """A well-formed prelude that decodes to all-zero freqs (M=0) must
    raise, not index mask=2^64-1 into the slot tables (regression:
    native SIGSEGV)."""
    import pytest
    from lane_ans.reference_model import interp as ip, vbyte, model
    from lane_ans.reference_model import rans_compat
    max_sym, frame_log = 3, 4
    n = max_sym + 1
    u = (1 << frame_log) + n + 1
    vals = np.arange(n, dtype=np.uint64)   # diffs of 1 -> nfreqs all 0
    buf = (vbyte.encode_u32(max_sym) + bytes([frame_log])
           + ip.encode(vals, n, u) + b"\x01" * 64)
    nf, _ = model.load_prelude(buf)
    assert int(np.asarray(nf).sum()) == 0
    with pytest.raises(ValueError):
        rans_compat.interleaved_decode(buf, 4, nf)


def test_shuff_truncated_stream_raises():
    """Truncated shuff payloads must fail, not silently emit the
    shortest codeword from the zero-refilled accumulator."""
    import pytest
    from lane_ans.models.shuff import Shuff
    v = (np.random.default_rng(3).zipf(1.3, 30000) - 1).astype(np.uint32)
    blob = Shuff().encode(v)
    with pytest.raises(ValueError):
        Shuff().decode(blob[: len(blob) // 2], len(v))
