"""Round-trip tests for the NumPy golden codecs (the framework oracle).

Mirrors the reference's REQUIRE_EQUAL-after-decode strategy
(reference: src/table_efficiency.cpp:104-106, include/cutil.hpp:30-50).
"""

import numpy as np
import pytest

from lane_ans.reference_model import rans_compat as rc


def _roundtrip(codec, values):
    blob = codec.encode(values)
    out = codec.decode(blob, len(values))
    np.testing.assert_array_equal(np.asarray(out, dtype=np.uint32), values)
    return blob


@pytest.mark.parametrize("name", ["zipf12", "geometric", "uniform_small",
                                  "tiny", "single_sym"])
def test_ans_int(datasets, name):
    _roundtrip(rc.AnsInt(), datasets[name])


@pytest.mark.parametrize("name", ["zipf12", "zipf_large", "geometric",
                                  "wide", "tiny", "single_sym"])
def test_ans_msb(datasets, name):
    _roundtrip(rc.AnsMsb(), datasets[name])


@pytest.mark.parametrize("fidelity", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", ["zipf_large", "wide", "tiny"])
def test_ans_fold(datasets, fidelity, name):
    _roundtrip(rc.AnsFold(fidelity), datasets[name])


@pytest.mark.parametrize("fidelity", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["zipf12", "zipf_large", "wide", "tiny"])
def test_ans_rfold(datasets, fidelity, name):
    _roundtrip(rc.AnsReorderFold(fidelity), datasets[name])


@pytest.mark.parametrize("h", [1, 10, 80, 320])
def test_ans_sint_smsb(datasets, h):
    _roundtrip(rc.AnsSint(h), datasets["zipf12"])
    _roundtrip(rc.AnsSmsb(h), datasets["zipf_large"])


def test_ans_byte(rng):
    data = rng.integers(0, 256, size=30000, dtype=np.uint8).tobytes()
    skewed = (rng.geometric(0.2, size=30000).clip(0, 255)
              .astype(np.uint8).tobytes())
    for d in (data, skewed):
        codec = rc.AnsByte()
        blob = codec.encode(d)
        assert codec.decode(blob, len(d)) == d


def test_h_approx_shrinks_frame(datasets):
    """Larger H_approx allows smaller frames (the Figure-12 tradeoff:
    smaller prelude, slightly worse stream)."""
    from lane_ans.reference_model.model import adjust_freqs
    v = datasets["zipf12"]
    freqs = np.bincount(v).astype(np.uint64)
    m1 = int(adjust_freqs(freqs, len(freqs) - 1, False, 1).sum())
    m320 = int(adjust_freqs(freqs, len(freqs) - 1, False, 320).sum())
    assert m320 <= m1


def test_lane_frame_cap_clamps_honest_search():
    """zipf-2^20-shaped histograms drive the honest adjust_freqs search
    past the lane format's 2^22 frame ceiling; lane codecs clamp
    max_frame=None to the ceiling instead of raising at encode (the
    compat engine stays truly uncapped).  Clamp is a no-op when the
    honest frame already fits."""
    from lane_ans.models.ans import LANE_FRAME_LIMIT, lane_frame_cap
    from lane_ans.reference_model.model import adjust_freqs
    # heavy head + a huge tail of singletons: honest frame > 2^22
    freqs = np.ones(1 << 20, dtype=np.uint64)
    freqs[:64] = 1 << 19
    honest = int(adjust_freqs(freqs, len(freqs) - 1, False, 1).sum())
    assert honest > LANE_FRAME_LIMIT
    capped = adjust_freqs(freqs, len(freqs) - 1, False, 1,
                          lane_frame_cap(None))
    assert int(capped.sum()) == LANE_FRAME_LIMIT
    # no-op below the ceiling
    small = np.ones(256, dtype=np.uint64)
    a = adjust_freqs(small, 255, False, 1)
    b = adjust_freqs(small, 255, False, 1, lane_frame_cap(None))
    np.testing.assert_array_equal(a, b)
    assert lane_frame_cap(1 << 14) == 1 << 14


def test_rfold_identity_mode_with_large_values():
    """Small alphabet + values >= fold threshold: the reference decoder
    mis-decodes this (ans_reorder_fold.hpp:288-302); we fix it."""
    values = np.array([3, 70000, 3, 3, 70000, 123456, 3, 9] * 10,
                      dtype=np.uint32)
    _roundtrip(rc.AnsReorderFold(1), values)
