"""Round-trip tests for the baseline codec family: byte splitters,
byte-entropy composites, OptPFor, shuff, arith, entropy_only.

Mirrors the reference's comparison-method registry
(reference: include/methods.hpp:38-637).
"""

import numpy as np
import pytest

from lane_ans import models


def _roundtrip(name, values):
    codec = models.get(name)
    blob = codec.encode(values)
    out = codec.decode(blob, len(values))
    np.testing.assert_array_equal(np.asarray(out, dtype=np.uint32), values)
    return blob


SPLITTERS = ["vbyte", "streamvbyte", "optpfor"]
ENTROPY = ["shuff", "arith", "fse", "huffzero"]
COMPOSITES = ["vbytefse", "vbytehuffzero", "vbyteANS",
              "streamvbytefse", "streamvbytehuffzero", "streamvbyteANS"]


@pytest.mark.parametrize("name", SPLITTERS)
@pytest.mark.parametrize("data", ["zipf12", "wide", "tiny", "geometric"])
def test_splitters(datasets, name, data):
    _roundtrip(name, datasets[data])


@pytest.mark.parametrize("name", ENTROPY)
def test_entropy_coders(datasets, name):
    v = datasets["zipf12"][:8000]
    blob = _roundtrip(name, v)
    from lane_ans.utils import metrics
    h0 = metrics.compute_entropy(v)
    if name in ("shuff", "arith"):
        # direct symbol coders should land near H0 (+ prelude slack)
        assert 8 * len(blob) / len(v) < h0 + 2.5
    else:
        # fse/huff0 code the raw u32 *bytes* (methods.hpp:159-176), so
        # they sit well above symbol H0 — like the reference's Table 9
        assert 8 * len(blob) / len(v) < 4 * 8


@pytest.mark.parametrize("name", COMPOSITES)
def test_composites(datasets, name):
    _roundtrip(name, datasets["zipf12"][:6000])
    _roundtrip(name, datasets["wide"][:4000])


def test_vbyte_bytes_exact():
    """vbyte wire format matches the scalar golden vbyte
    (include/vbyte.hpp:32-95)."""
    from lane_ans.reference_model import vbyte as vb
    vals = np.array([0, 1, 127, 128, 300, 1 << 20, (1 << 32) - 1],
                    dtype=np.uint32)
    blob = models.get("vbyte").encode(vals)
    expect = b"".join(vb.encode_u32(int(v)) for v in vals)
    assert blob == expect


def test_optpfor_beats_vbyte_on_packed_data(rng):
    v = rng.integers(0, 64, size=12800).astype(np.uint32)  # 6-bit data
    pf = models.get("optpfor").encode(v)
    vbb = models.get("vbyte").encode(v)
    assert len(pf) < len(vbb)


def test_entropy_only(datasets):
    from lane_ans.utils import metrics
    v = datasets["zipf12"]
    blob = models.get("entropy_only").encode(v)
    assert len(blob) == int(np.ceil(
        metrics.compute_entropy(v) * len(v) / 8.0))
    with pytest.raises(RuntimeError):
        models.get("entropy_only").decode(blob, len(v))


def test_shuff_single_and_skewed():
    _roundtrip("shuff", np.full(300, 9, np.uint32))
    _roundtrip("arith", np.full(300, 9, np.uint32))
    skew = np.r_[np.zeros(10000), np.arange(40)].astype(np.uint32)
    _roundtrip("shuff", skew)
    _roundtrip("arith", skew)


def test_shuff_rejects_corrupt_wire():
    """Forged header max_len must not drive the >16-bit scan past the
    canonical tables, and truncated payloads must raise on BOTH
    backends (the zero-refilled accumulator can keep 'matching')."""
    import lane_ans.models.shuff as sh
    from lane_ans.reference_model import vbyte
    vals = (np.random.default_rng(3).zipf(1.3, 5000) - 1).astype(
        np.uint32)
    c = sh.Shuff()
    blob = c.encode(vals)
    _, p1 = vbyte.decode_u32(blob, 0)
    _, p2 = vbyte.decode_u32(blob, p1)
    _, p3 = vbyte.decode_u32(blob, p2)
    forged = blob[:p2] + bytes(vbyte.encode_u32(60)) + blob[p3:]
    trunc = blob[:-10]
    with pytest.raises(ValueError, match="corrupt shuff"):
        c.decode(forged, len(vals))
    with pytest.raises(ValueError):
        c.decode(trunc, len(vals))
    orig = sh._native
    sh._native = lambda: None
    try:
        with pytest.raises(ValueError, match="corrupt shuff"):
            c.decode(forged, len(vals))
        with pytest.raises(ValueError):
            c.decode(trunc, len(vals))
    finally:
        sh._native = orig


def test_arith_native_matches_python_wire():
    """The compiled range-coder loops (ans_native.cpp arith_encode/
    arith_decode) must emit and consume byte-identical streams to the
    Python fallback, including the pow2-total shift and the 16-bit
    jump-table search."""
    import lane_ans.models.arith as am
    rng = np.random.default_rng(17)
    for vals in (
        (rng.zipf(1.3, 30000) - 1).clip(0, 1 << 24).astype(np.uint32),
        rng.integers(0, 1 << 14, 30000, dtype=np.uint32),
        np.zeros(100, np.uint32),  # single-symbol model
    ):
        c = am.Arith()
        native_blob = c.encode(vals)
        out_native = c.decode(native_blob, len(vals))
        orig = am._native
        am._native = lambda: None
        try:
            py_blob = c.encode(vals)
            assert py_blob == native_blob
            out_py = c.decode(native_blob, len(vals))
        finally:
            am._native = orig
        np.testing.assert_array_equal(out_native, vals)
        np.testing.assert_array_equal(out_py, vals)


def test_arith_rejects_corrupt_wire():
    """Forged total_log2 or a non-increasing frequency prelude must
    raise, not SIGFPE in the native loop (rng collapses to 0 and the
    next (code-low)/r divides by zero)."""
    import lane_ans.models.arith as am
    from lane_ans.reference_model import vbyte
    vals = (np.random.default_rng(5).zipf(1.4, 5000) - 1).astype(
        np.uint32)
    c = am.Arith()
    blob = c.encode(vals)
    _, p1 = vbyte.decode_u32(blob, 0)
    _, p2 = vbyte.decode_u32(blob, p1)
    forged = bytearray(blob)
    tl2 = forged[p2]
    forged[p2] = 40  # total_log2 out of range
    with pytest.raises(ValueError, match="corrupt arith"):
        c.decode(bytes(forged), len(vals))
    # in-range but wrong: the frequency-sum check must fire
    forged[p2] = 17 if tl2 != 17 else 18
    with pytest.raises(ValueError, match="corrupt arith"):
        c.decode(bytes(forged), len(vals))


def test_shuff_pure_python_fallback_matches_native():
    """The numpy packer/decoder must work (and emit identical bytes)
    when libansnative.so is absent — regression for a uint64/int64
    shift-type crash in _pack_msb_numpy."""
    import lane_ans.models.shuff as sh
    vals = (np.random.default_rng(21).zipf(1.3, 20000) - 1).astype(
        np.uint32)
    c = sh.Shuff()
    native_blob = c.encode(vals)
    orig = sh._native
    sh._native = lambda: None
    try:
        py_blob = c.encode(vals)
        assert py_blob == native_blob
        np.testing.assert_array_equal(c.decode(native_blob, len(vals)),
                                      vals)
    finally:
        sh._native = orig
