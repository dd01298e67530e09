"""Tail-escape recoding tests (ops/escape.py) — CPU, interpreter-mode
Pallas where a kernel is involved.

The escape plan is a FORMAT derivation (pure function of the prelude
frequency vector, like the grouped layout), so the tests cover: the
plan's invariants (frame partition, loss accounting, byte-bucket
mapping), both coder sides deriving the same plan from the wire,
engagement/decline boundaries, the end-to-end codec round-trip on the
XLA engine, the pivot-search Pallas kernel decoding an escaped wire in
interpreter mode, and the blocked runtime.
"""

import numpy as np
import pytest

from lane_ans import models
from lane_ans.models.ans import AnsInt, AnsSint
from lane_ans.ops import escape
from lane_ans.reference_model.model import adjust_freqs, load_prelude


@pytest.fixture(scope="module")
def engaged_values():
    """Hot head (4096 values, freq 32) + dense byte-aligned uniform
    tail: every escape bucket is full and equal-frequency, so the loss
    is ~0 and the plan engages."""
    rng = np.random.default_rng(0)
    hot = np.repeat(np.arange(4096, dtype=np.uint32), 32)
    tail = np.tile(np.arange(4096, 4096 + 16384, dtype=np.uint32), 8)
    vals = np.concatenate([hot, tail])
    rng.shuffle(vals)
    return vals


def _plan_of(values, h_approx=1):
    freqs = np.bincount(values, minlength=int(values.max()) + 1
                        ).astype(np.uint64)
    nfreqs = adjust_freqs(freqs, int(values.max()), False, h_approx,
                          1 << 22)
    return escape.plan_from_freqs(nfreqs), nfreqs


def test_plan_invariants(engaged_values):
    plan, nfreqs = _plan_of(engaged_values)
    assert plan is not None
    M = int(nfreqs.sum())
    # the folded frame partitions the original frame exactly
    assert int(plan.frame_freqs.sum()) == M
    assert len(plan.frame_freqs) == plan.K + plan.num_variants
    assert (plan.frame_freqs > 0).all()
    # hot symbols: full value stored, no exception bytes
    assert (plan.sym_nb[:plan.K] == 0).all()
    # escape symbols: high bits aligned, nb raw bytes
    assert (plan.sym_nb[plan.K:] == plan.nb).all()
    v_high = plan.sym_high[plan.K:].astype(np.uint64)
    assert (v_high & ((1 << (8 * plan.nb)) - 1) == 0).all()
    assert abs(plan.loss_bits) <= escape.REL_LOSS_BUDGET * 32


def test_map_values_reconstruct(engaged_values):
    plan, _ = _plan_of(engaged_values)
    mapped, k, b = plan.map_values(engaged_values)
    assert mapped.max() < plan.K + plan.num_variants
    # reconstruct: value = sym_high[mapped] + little-endian k low bytes
    low = np.zeros(len(mapped), np.uint32)
    for j in range(3):
        low |= np.where(k > j, b[:, j].astype(np.uint32) << (8 * j), 0)
    rec = plan.sym_high[mapped] + low
    np.testing.assert_array_equal(rec, engaged_values)
    # hot elements carry no exception bytes
    assert (k[mapped < plan.K] == 0).all()


def test_small_k_prefers_loss_free():
    """A flat 2^16 alphabet admits two near-equal folds: K=1024/nb=1
    (sigma'=1276, loss exactly 0) and K=1024/nb=2 (sigma'=1025, but the
    single merged bucket pays ~+0.14%).  The 1024-bucketed plan key
    must treat the sizes as equal and pick the loss-free cut."""
    v = np.tile(np.arange(1 << 16, dtype=np.uint32), 16)
    plan, _ = _plan_of(v)
    assert plan is not None
    assert (plan.K, plan.nb) == (1024, 1)
    assert plan.K + plan.num_variants == 1276
    assert plan.loss_bits == 0.0


def test_declines_small_alphabet():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 5000, 1 << 14).astype(np.uint32)
    plan, _ = _plan_of(v)
    assert plan is None


def test_declines_mixed_freq_tail():
    """Tail frequencies alternating 1/2 make the merged-bucket Jensen
    gap exceed the budget: the plan must decline (the grouped layout
    then carries the frame, tests/test_grouped.py)."""
    vals = np.concatenate([np.arange(16384, dtype=np.uint32),
                           np.arange(0, 16384, 2, dtype=np.uint32)])
    plan, nfreqs = _plan_of(vals)
    assert plan is None
    from lane_ans.ops import grouped
    assert grouped.use_grouped_layout(nfreqs)


def test_roundtrip_xla(engaged_values):
    c = AnsInt(lanes=256)
    blob = c.encode(engaged_values)
    out = c.decode(blob, len(engaged_values))
    np.testing.assert_array_equal(out, engaged_values)
    # the wire prelude re-derives the identical plan
    plan, _ = _plan_of(engaged_values)
    nf_wire, _ = load_prelude(blob)
    p2 = escape.plan_from_freqs(nf_wire)
    assert p2 is not None and p2.K == plan.K and p2.nb == plan.nb
    np.testing.assert_array_equal(p2.frame_freqs, plan.frame_freqs)
    np.testing.assert_array_equal(p2.sym_high, plan.sym_high)


def test_roundtrip_sint(engaged_values):
    c = AnsSint(4, lanes=256)
    blob = c.encode(engaged_values)
    np.testing.assert_array_equal(c.decode(blob, len(engaged_values)),
                                  engaged_values)


def test_bpi_near_entropy(engaged_values):
    """Escape must not cost measurable size on its engagement case."""
    n = len(engaged_values)
    freqs = np.bincount(engaged_values)
    p = freqs[freqs > 0] / n
    H = float(-(p * np.log2(p)).sum())
    blob = AnsInt(lanes=256).encode(engaged_values)
    bpi = len(blob) * 8 / n
    # prelude for sigma=20480 symbols is a few KB; allow it + 1%
    assert bpi <= H * 1.01 + (3000 * 8) / n


def test_pallas_search_kernel_interpret(engaged_values):
    """The escaped wire decodes through the fused decode kernel (the GPU
    engine) in interpreter mode, bit for bit like the XLA scan."""
    n = len(engaged_values)
    blob = AnsInt(lanes=256).encode(engaged_values)
    prep = models.prepare_decoder("ANS", blob, n, engine="kernel",
                                  interpret=True)
    assert prep.engine == "kernel"
    out = np.asarray(prep())
    xla = models.prepare_decoder("ANS", blob, n, engine="xla")
    np.testing.assert_array_equal(out, np.asarray(xla()))
    np.testing.assert_array_equal(prep.to_host(out), engaged_values)


def test_blocked_roundtrip(engaged_values):
    from lane_ans.parallel import block_runtime
    mesh = block_runtime.make_mesh(4)
    codec = block_runtime.BlockCodec("ANS", mesh, lanes=256)
    blob = codec.encode(engaged_values)
    out = codec.decode(blob)
    np.testing.assert_array_equal(out, engaged_values)


def test_corrupt_escape_wire(engaged_values):
    """Byte mutations across an escaped wire must decode to garbage or
    raise ValueError — never crash (the registry-wide corrupt sweep's
    datasets stay below the escape threshold, so cover it here)."""
    rng = np.random.default_rng(7)
    c = AnsInt(lanes=256)
    blob = bytearray(c.encode(engaged_values))
    n = len(engaged_values)
    for _ in range(24):
        pos = int(rng.integers(0, len(blob)))
        old = blob[pos]
        blob[pos] ^= int(rng.integers(1, 256))
        try:
            out = c.decode(bytes(blob), n)
            assert len(out) == n
        except (ValueError, KeyError):
            pass
        blob[pos] = old
    # truncations at every region boundary
    for cut in (1, 16, len(blob) // 2, len(blob) - 2):
        try:
            c.decode(bytes(blob[:cut]), n)
        except (ValueError, KeyError, IndexError):
            pass
