"""Device-resident encode (models.prepare_encoder / PreparedEncoder)
against the one-shot codec: the staged lane encode scan + placement must
reproduce codec.encode's container byte for byte, across ragged tails,
section cuts, large frames and degenerate models."""

import jax.numpy as jnp
import numpy as np
import pytest

from lane_ans import models
from lane_ans.models import framing
from lane_ans.models.ans import AnsFold, AnsInt, _stage_ts
from lane_ans.models.engine import PreparedEncoder
from lane_ans.ops import lane_codec, tables

from kernel_cases import kernel_vs_xla


def prepared_blob(name, values, lanes):
    pe = models.prepare_encoder(name, values, lanes=lanes)
    return pe.prelude + pe.to_bytes(*pe())


@pytest.mark.parametrize("n_take", [128 * 40 + 7, 4096])
def test_pallas_encode_matches_xla(n_take):
    rng = np.random.default_rng(11)
    values = (rng.zipf(1.3, size=n_take) - 1).clip(0, 1 << 27).astype(
        np.uint32)
    blob = prepared_blob("ANSfold-2", values, 128)
    assert blob == AnsFold(2, lanes=128).encode(values)


def test_pallas_place_matches_scatter():
    """A stream long enough for several sections: the prepared encoder's
    section table and bytes equal the one-shot codec's, and the stream
    equals the raw placement output."""
    rng = np.random.default_rng(4)
    values = (rng.zipf(1.35, size=30000) - 1).clip(0, 1 << 26).astype(
        np.uint32)
    pe = models.prepare_encoder("ANSfold-2", values, lanes=128)
    stream, total, states, step_base = pe()
    body = pe.to_bytes(stream, total, states, step_base)
    assert pe.prelude + body == AnsFold(2, lanes=128).encode(values)
    _, st, payload, t_sec, sec_len = framing.parse(body, 0)
    assert int(sec_len.sum()) == int(total)
    np.testing.assert_array_equal(payload,
                                  np.asarray(stream[: int(total)]))
    np.testing.assert_array_equal(st, np.asarray(states))


def test_pallas_encode_big_frame():
    """A hand-built 2^17 frame (3 renorm rounds): PreparedEncoder's
    bytes equal framing of the raw encode_lanes output, and the stream
    decodes back (kernel and XLA scan)."""
    rng = np.random.default_rng(3)
    sigma = 4096
    values = rng.integers(0, sigma, size=30000).astype(np.uint32)
    nfreqs = np.full(sigma, 32, dtype=np.uint64)  # M = 2^17
    et = tables.build_enc_table(nfreqs)
    assert et.log2m == 17
    S, n = 128, len(values)
    T = lane_codec.lane_steps(n, S)
    staged = _stage_ts(jnp.asarray(values), None, None, n, S, T)
    pe = PreparedEncoder(*staged, n, et, S=S, T=T)
    body = pe.to_bytes(*pe())
    raw = lane_codec.encode_lanes(*staged, jnp.int32(n),
                                  jnp.asarray(et.freq),
                                  jnp.asarray(et.base), jnp.asarray(et.ub),
                                  S=S, T=T, log2m=et.log2m)
    assert body == framing.pack_encoded(*raw, T)
    _, states, payload, _, _ = framing.parse(body, 0)
    kernel_vs_xla(payload, states, tables.build_dec_table(nfreqs), n, S,
                  values)


def test_pallas_encode_single_symbol_freq():
    """Degenerate-ish model: one dominant symbol (freq near M) plus a
    rare one."""
    values = np.r_[np.zeros(5000, np.uint32), [5, 9, 5]].astype(np.uint32)
    np.random.default_rng(0).shuffle(values)
    blob = prepared_blob("ANSfold-1", values, 128)
    codec = AnsFold(1, lanes=128)
    assert blob == codec.encode(values)
    np.testing.assert_array_equal(codec.decode(blob, len(values)), values)


def test_lanes_must_be_power_of_two():
    """The fmt-2 header stores log2(S) — non-pow2 lane counts must be
    rejected up front (regression: lanes=384 previously reached the
    engines and crashed in framing.pack)."""
    from lane_ans.parallel import BlockCodec, make_mesh
    with pytest.raises(ValueError, match="power of two"):
        AnsFold(2, lanes=384)
    with pytest.raises(ValueError, match="power of two"):
        BlockCodec("ANSfold-2", make_mesh(1), lanes=384)
    with pytest.raises(ValueError, match="power of two"):
        models.prepare_encoder("ANS", np.arange(100, dtype=np.uint32),
                               lanes=384)
    assert AnsInt(lanes=256).lanes == 256
