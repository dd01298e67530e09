"""tANS (models/tans.py) — the FSE-equivalent byte entropy stage.

No wire-parity constraint exists (the reference's fse wraps the
unvendored external FSE library), so the properties under test are:
the state machine is an exact inverse pair, the native hot loops match
the pure-Python spec bit-for-bit, and compression sits within ~1% of
the empirical byte entropy (FSE's own regime)."""

import numpy as np
import pytest

from lane_ans.models import tans
from lane_ans.reference_model.rans_compat import byte_adjust_freqs


def _tables(data):
    freqs = np.bincount(data, minlength=256).astype(np.uint64)
    return freqs, tans.build_tables(byte_adjust_freqs(freqs))


CASES = {
    "uniform": lambda r: r.integers(0, 256, 4000, dtype=np.uint8),
    "zipf": lambda r: (r.zipf(1.3, 20000) % 256).astype(np.uint8),
    "skewed4": lambda r: r.integers(0, 4, 30000, dtype=np.uint8),
    "single": lambda r: np.zeros(500, np.uint8),
    "one-elem": lambda r: np.array([7], np.uint8),
    "two-sym-extreme": lambda r: np.where(
        r.random(10000) < 0.999, 0, 255).astype(np.uint8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_python_roundtrip(case):
    data = CASES[case](np.random.default_rng(3))
    _, t = _tables(data)
    st, tb, pl = tans._encode_py(data, t)
    out = tans._decode_py(pl, tb, st, len(data), t)
    np.testing.assert_array_equal(out.astype(np.uint8), data)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_matches_python(case):
    from lane_ans import native
    if native.lib is None:
        pytest.skip("native backend not built")
    data = CASES[case](np.random.default_rng(3))
    _, t = _tables(data)
    st, tb, pl = tans._encode_py(data, t)
    st2, tb2, pl2 = native.lib.tans_encode(data.astype(np.uint32), t)
    assert (st, tb, pl) == (st2, tb2, pl2)
    out = native.lib.tans_decode(pl2, tb2, st2, len(data), t)
    np.testing.assert_array_equal(out.astype(np.uint8), data)


def test_table_invariants():
    data = CASES["zipf"](np.random.default_rng(7))
    _, t = _tables(data)
    L, R = t["L"], t["R"]
    assert 1 << R == L
    # per symbol, its slots' transition ranges [base, base + 2^nb)
    # tile [L, 2L) exactly (any state can precede any symbol)
    sym = t["sym"]
    for s in np.unique(sym):
        spans = sorted((int(b), int(b) + (1 << int(nb)))
                       for b, nb in zip(t["base"][sym == s],
                                        t["nbt"][sym == s]))
        assert spans[0][0] == L and spans[-1][1] == 2 * L
        for (_, a1), (b0, _) in zip(spans, spans[1:]):
            assert a1 == b0, f"symbol {s} ranges must tile [L,2L)"
    # encode table is a permutation of the decode states
    assert sorted(t["enc_next"]) == list(range(L, 2 * L))


def test_compression_near_entropy():
    data = CASES["zipf"](np.random.default_rng(11))
    bt = tans.ByteTans()
    blob = bt.encode(data.tobytes())
    freqs = np.bincount(data, minlength=256)
    p = freqs[freqs > 0] / len(data)
    h0 = float(-(p * np.log2(p)).sum())
    stream_bpi = 8 * (len(blob) - 600) / len(data)  # ex prelude bound
    assert stream_bpi < h0 * 1.02 + 0.08


def test_fse_method_roundtrip_and_empty():
    from lane_ans import models
    c = models.get("fse")
    vals = (np.random.default_rng(5).zipf(1.2, 8192) - 1).astype(
        np.uint32)
    blob = c.encode(vals)
    np.testing.assert_array_equal(c.decode(blob, len(vals)), vals)
    with pytest.raises(ValueError):
        c.encode(np.array([], np.uint32))


def test_native_hist_u8_matches_bincount():
    from lane_ans import native
    if native.lib is None:
        pytest.skip("native backend not built")
    data = np.random.default_rng(13).integers(
        0, 256, 100003).astype(np.uint8)
    np.testing.assert_array_equal(
        native.lib.hist_u8(data),
        np.bincount(data, minlength=256).astype(np.uint64))
    np.testing.assert_array_equal(
        native.lib.hist_u8(data[:0]), np.zeros(256, np.uint64))


def test_native_decode_rejects_corrupt_streams():
    """Wire-supplied states/bit-count must fail cleanly, never read out
    of the table or before the payload buffer."""
    from lane_ans import native
    if native.lib is None:
        pytest.skip("native backend not built")
    data = CASES["zipf"](np.random.default_rng(17)).tobytes()
    bt = tans.ByteTans()
    blob = bt.encode(data)
    from lane_ans.constants import BYTE_MAX_FRAME_SIZE, BYTE_MAX_SIGMA
    from lane_ans.reference_model import interp
    _, words = interp.decode(blob, BYTE_MAX_SIGMA,
                             BYTE_MAX_FRAME_SIZE + BYTE_MAX_SIGMA)
    off = words * 4
    bad_state = bytearray(blob)
    bad_state[off + 1] = 0xFF            # state 0 far beyond the table
    with pytest.raises(ValueError):
        bt.decode(bytes(bad_state), len(data))
    bad_bits = bytearray(blob)
    bad_bits[off + 8:off + 16] = (5).to_bytes(8, "little")
    with pytest.raises(ValueError):
        bt.decode(bytes(bad_bits), len(data))
    # forged/inflated total_bits: the payload slice would silently
    # truncate to the container, then the native decoder would read at
    # payload + (total_bits >> 3), far out of bounds
    forged = bytearray(blob)
    forged[off + 8:off + 16] = (1 << 40).to_bytes(8, "little")
    with pytest.raises(ValueError, match="corrupt tans"):
        bt.decode(bytes(forged), len(data))
    with pytest.raises(ValueError, match="corrupt tans"):
        bt.decode(blob[:off + 20], len(data))  # truncated container
