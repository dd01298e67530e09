"""Round-trip + format tests for the S-lane engine (ops.lane_codec,
models.ans) on the CPU backend.

Mirrors the reference's REQUIRE_EQUAL-after-decode strategy
(reference: src/table_efficiency.cpp:104-106) plus lane-format-specific
properties: compressed size stays within the lane directory overhead of
the compat format, and streams decode independently of lane count used
elsewhere.
"""

import numpy as np
import pytest

from lane_ans import models
from lane_ans.models import config, framing
from lane_ans.reference_model import rans_compat as rc

LANES = 64  # fixed for tests: bounds jit cache growth


def _lane(name, lanes=None):
    c = models.get(name, "lane")
    c.lanes = lanes or LANES
    return c


def _roundtrip(codec, values):
    blob = codec.encode(values)
    out = codec.decode(blob, len(values))
    np.testing.assert_array_equal(out, values)
    return blob


@pytest.mark.parametrize("name", ["zipf12", "geometric", "uniform_small",
                                  "tiny", "single_sym"])
def test_lane_ans_int(datasets, name):
    _roundtrip(_lane("ANS"), datasets[name])


@pytest.mark.parametrize("name", ["zipf12", "zipf_large", "geometric",
                                  "wide", "tiny", "single_sym"])
def test_lane_ans_msb(datasets, name):
    _roundtrip(_lane("ANSmsb"), datasets[name])


@pytest.mark.parametrize("fidelity", [1, 2, 3, 4, 8])
def test_lane_ans_fold(datasets, fidelity):
    _roundtrip(_lane(f"ANSfold-{fidelity}"), datasets["zipf_large"])
    _roundtrip(_lane(f"ANSfold-{fidelity}"), datasets["wide"])


@pytest.mark.parametrize("fidelity", [1, 2, 4])
def test_lane_ans_rfold(datasets, fidelity):
    _roundtrip(_lane(f"ANSrfold-{fidelity}"), datasets["zipf12"])
    _roundtrip(_lane(f"ANSrfold-{fidelity}"), datasets["zipf_large"])


@pytest.mark.parametrize("h", [1, 80, 320])
def test_lane_sint_smsb(datasets, h):
    _roundtrip(_lane(f"ANSsint-{h}"), datasets["zipf12"])
    _roundtrip(_lane(f"ANSsmsb-{h}"), datasets["zipf_large"])


def test_lane_edge_cases():
    for vals in [np.array([7], dtype=np.uint32),
                 np.full(3, 9, np.uint32),
                 np.arange(LANES, dtype=np.uint32),          # exactly S
                 np.arange(LANES + 1, dtype=np.uint32),      # S + 1
                 np.full(1000, 0, np.uint32),
                 np.array([0xFFFFFFFF, 0, 0xFFFFFFFF, 1], np.uint32)]:
        for name in ["ANS", "ANSmsb", "ANSfold-3", "ANSrfold-1"]:
            if name == "ANS" and vals.max() > (1 << 22):
                continue  # fmt A frame cap; huge raw alphabets use msb/fold
            _roundtrip(_lane(name), vals)


def test_lane_empty_raises():
    with pytest.raises(ValueError):
        _lane("ANSmsb").encode(np.empty(0, np.uint32))


def test_lane_size_near_compat(datasets):
    """Lane BPI <= compat BPI + directory overhead (8-bit renorm can only
    tighten the stream vs 32-bit renorm)."""
    v = datasets["zipf_large"]
    for name, compat in [("ANSmsb", rc.AnsMsb()), ("ANSfold-2", rc.AnsFold(2))]:
        lane_blob = _lane(name).encode(v)
        compat_blob = compat.encode(v)
        slack = framing.overhead_bytes(LANES) + 8
        assert len(lane_blob) <= len(compat_blob) + slack


def test_lane_count_config():
    assert config.default_lane_count(100) == 32
    assert config.default_lane_count(100_000_000) == 4096  # capped
    assert config.default_lane_count(20_000_000) == 2048
    s = config.default_lane_count(10_000_000)
    assert s & (s - 1) == 0


def test_decode_is_size_directed(datasets):
    """Decoding a prefix: caller-supplied n governs output length (the
    reference contract; streams are not self-terminating)."""
    v = datasets["zipf12"]
    blob = _lane("ANSmsb").encode(v)
    out = _lane("ANSmsb").decode(blob, len(v))
    assert len(out) == len(v)


def test_prepared_decoder_api(datasets):
    """PreparedDecoder: stage once, decode repeatedly (serving path)."""
    from lane_ans.models import framing
    from lane_ans.models.engine import PreparedDecoder
    from lane_ans.ops import lane_codec, tables
    from lane_ans.reference_model import mappings as map_np
    from lane_ans.reference_model.model import load_prelude

    v = datasets["zipf_large"]
    codec = _lane("ANSfold-2")
    blob = codec.encode(v)
    nfreqs, plen = load_prelude(blob)
    syms = np.arange(len(nfreqs), dtype=np.uint32)
    high, nb = map_np.fold_unmap_high(syms, 2)
    dt = tables.build_dec_table(nfreqs, high, nb)
    S, states, payload, _, _ = framing.parse(blob, plen)
    prep = PreparedDecoder(payload, states, dt, len(v), S=S,
                           T=lane_codec.lane_steps(len(v), S),
                           has_exc=True)
    for _ in range(2):  # re-runnable without re-staging
        np.testing.assert_array_equal(prep.to_host(prep()), v)


@pytest.mark.parametrize("S", [1, 2, 4, 8, 16, 32, 64])
def test_kernel_small_lane_counts(datasets, S):
    """The decode kernel pads S up to its minimum block width: the padded
    lanes stay invalid, the output keeps S columns, and it matches the
    XLA scan bit for bit (kernel interpreted)."""
    from kernel_cases import run_blob
    from lane_ans.ops import lane_kernel
    v = datasets["zipf12"][:3001]
    assert lane_kernel.padded_lanes(S) == max(S, lane_kernel.MIN_LANES)
    run_blob("ANSmsb", _lane("ANSmsb", lanes=S), v)


def test_kernel_wrapper_shapes():
    """padded_lanes / num_warps policy and the lane cap."""
    from lane_ans.ops import lane_kernel
    assert lane_kernel.padded_lanes(4096) == 4096
    assert lane_kernel.num_warps(32) == 4
    assert lane_kernel.num_warps(4096) == 32
    assert lane_kernel.num_warps(1 << 14) == 32
    with pytest.raises(ValueError, match="S <="):
        lane_kernel.padded_lanes(2 * lane_kernel.MAX_LANES)
