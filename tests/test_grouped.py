"""Frequency-grouped slot layout tests (CPU; decode kernel interpreted).

The grouped slot layout (ops/grouped.py) is the frame order for
genuinely large alphabets (sigma > 2^13: ans_int over zipf-2^20 / word
ids / uniform16+).  These tests cover the layout math (group bound,
base permutation), the decode kernel against the XLA scan on grouped
tables (sparse/dense ans_int, exceptions, multi-section, fold), the
prepared encoder against the one-shot codec byte for byte, the block
runtime, and the end-to-end codec round-trips under the layout.
"""

import functools

import numpy as np
import pytest

from lane_ans import models
from lane_ans.models import framing
from lane_ans.models.ans import AnsInt, AnsMsb
from lane_ans.ops import grouped, tables
from lane_ans.reference_model import mappings as map_np
from lane_ans.reference_model.model import adjust_freqs, load_prelude

from kernel_cases import encode_staged, kernel_vs_xla, run_blob


@pytest.fixture(scope="module")
def big_sparse():
    """sigma > 2^13 with gaps (value table needed)."""
    rng = np.random.default_rng(7)
    base = np.repeat(np.arange(9000, dtype=np.uint32) * 3, 2)
    tail = (rng.zipf(1.2, size=42000) - 1).clip(0, 60000)
    return np.concatenate([base, tail]).astype(np.uint32)


@pytest.fixture(scope="module")
def big_dense():
    """every value 0..11999 present (still needs the val planes: rank
    order is frequency-sorted, not value order).  Tail frequencies
    alternate 1/2 so the escape recoding's Jensen-gap loss exceeds its
    budget and the wire stays on the grouped layout (ops/escape.py
    declines; this file tests the grouped engine)."""
    rng = np.random.default_rng(8)
    extra = (rng.zipf(1.5, size=30000) - 1).clip(0, 11999)
    return np.concatenate([np.arange(12000, dtype=np.uint32),
                           np.arange(0, 12000, 2, dtype=np.uint32),
                           extra.astype(np.uint32)])


def test_layout_invariants(big_sparse):
    freqs = np.bincount(big_sparse).astype(np.uint64)
    nfreqs = adjust_freqs(freqs, int(big_sparse.max()), False, 1)
    lay = grouped.build_group_layout(nfreqs)
    M = lay.frame_size
    # the sqrt(2M) group bound is structural, not data luck
    assert lay.num_groups <= int(np.sqrt(2 * M)) + 1
    nz = np.flatnonzero(nfreqs)
    assert lay.sigma == len(nz)
    # perm sorted by (freq desc, value asc)
    f_of = np.asarray(nfreqs, dtype=np.int64)[lay.perm]
    assert (np.diff(f_of) <= 0).all()
    same = np.flatnonzero(np.diff(f_of) == 0)
    assert (lay.perm[same + 1] > lay.perm[same]).all()
    # rank_of inverts perm
    assert (lay.rank_of[lay.perm]
            == np.arange(lay.sigma, dtype=np.uint32)).all()
    # group tables describe contiguous slot runs covering [0, M)
    counts = np.diff(np.append(lay.g_rank0, lay.sigma))
    assert int((counts * lay.g_f.astype(np.int64)).sum()) == M
    # base_of_symbol == brute-force cumulative in rank order
    base_rank = np.concatenate(
        ([0], np.cumsum(np.asarray(nfreqs)[lay.perm])[:-1]))
    bos = lay.base_of_symbol()
    np.testing.assert_array_equal(bos[lay.perm], base_rank)


def test_group_bound_is_tight_on_adversarial_freqs():
    """Max distinct frequencies: 1+2+...+k style frame."""
    f = np.arange(1, 90, dtype=np.uint64)
    M = 1 << 12
    f = np.append(f, M - f.sum())
    lay = grouped.build_group_layout(f)
    assert lay.num_groups == len(np.unique(f))
    assert lay.num_groups <= int(np.sqrt(2 * M)) + 1


def test_plane_packing_roundtrip(big_sparse):
    """The encoder's per-symbol bases follow the layout: every live
    symbol's slot run [base, base + f) lies inside the frame and the
    runs tile it exactly."""
    freqs = np.bincount(big_sparse).astype(np.uint64)
    nfreqs = adjust_freqs(freqs, int(big_sparse.max()), False, 1)
    lay = grouped.build_group_layout(nfreqs)
    et = tables.build_enc_table(nfreqs, lay)
    np.testing.assert_array_equal(et.base, lay.base_of_symbol())
    live = np.flatnonzero(nfreqs)
    starts = et.base[live].astype(np.int64)
    ends = starts + np.asarray(nfreqs, dtype=np.int64)[live]
    order = np.argsort(starts)
    assert starts[order][0] == 0 and ends[order][-1] == lay.frame_size
    np.testing.assert_array_equal(starts[order][1:], ends[order][:-1])


def test_use_grouped_layout_is_format_stable():
    """The layout decision is format: changing it breaks every stored
    fmt-2 blob with a large alphabet.  2^13 present symbols -> classic
    layout; one more -> grouped."""
    nf = np.ones(1 << 13, np.uint64)
    assert not grouped.use_grouped_layout(nf)
    nf2 = np.ones((1 << 13) + 1, np.uint64)
    assert grouped.use_grouped_layout(nf2)


def test_grouped_decode_sparse(big_sparse):
    blob = run_blob("ANS", AnsInt(lanes=256), big_sparse)
    nfreqs, _ = load_prelude(blob)
    assert grouped.use_grouped_layout(nfreqs), "fixture sigma too small"
    assert (np.asarray(nfreqs) == 0).any()  # sparse: gaps in the values


def test_grouped_decode_dense(big_dense):
    blob = run_blob("ANS", AnsInt(lanes=256), big_dense)
    nfreqs, _ = load_prelude(blob)
    lay = grouped.build_group_layout(nfreqs)
    # dense values, but slots follow the frequency order
    assert not (lay.perm == np.arange(lay.sigma)).all()


def test_grouped_decode_exceptions_synthetic():
    """Exception path (NE > 0): a fold-like synthetic coder whose
    low byte rides the exception stream while the grouped table
    reconstructs high = sym << 8.  No public codec but fold-7 reaches
    sigma > 2^13 WITH exceptions (msb's alphabet caps at 1280), so the
    grouped high/nb tables are exercised directly."""
    rng = np.random.default_rng(9)
    sym = np.concatenate([
        np.arange(9000, dtype=np.uint32),
        (rng.zipf(1.3, size=40000) - 1).clip(0, 12000).astype(np.uint32)])
    vals = ((sym << np.uint32(8))
            | rng.integers(0, 256, size=len(sym)).astype(np.uint32))
    freqs = np.bincount(sym).astype(np.uint64)
    nfreqs = adjust_freqs(freqs, int(sym.max()), True, 1)
    assert grouped.use_grouped_layout(nfreqs)
    lay = grouped.build_group_layout(nfreqs)
    sigma_all = len(nfreqs)
    sym_high = (np.arange(sigma_all, dtype=np.uint32) << 8)
    sym_nb = np.ones(sigma_all, np.uint32)
    nb = np.ones(len(vals), np.uint32)
    excb = np.zeros((len(vals), 3), np.uint8)
    excb[:, 0] = vals & 0xFF
    S = 256
    stream, _, states, _, _ = encode_staged(sym, nb, excb, nfreqs, S, lay)
    dt = tables.build_dec_table(nfreqs, sym_high, sym_nb, layout=lay,
                                slots=False)
    assert dt.has_exc and dt.freq is None
    kernel_vs_xla(stream, states, dt, len(vals), S, vals)


def test_grouped_decode_multisection(big_sparse):
    """Force several stream sections (tiny cap re-cut of the XLA
    encoder's step bases)."""
    freqs = np.bincount(big_sparse).astype(np.uint64)
    nfreqs = adjust_freqs(freqs, int(big_sparse.max()), False, 1)
    lay = grouped.build_group_layout(nfreqs)
    n = len(big_sparse)
    S = 128
    nbz = np.zeros(n, np.uint32)
    excbz = np.zeros((n, 3), np.uint8)
    stream, total, states, step_base, T = encode_staged(
        big_sparse, nbz, excbz, nfreqs, S, lay)
    t_sec, sec_len = framing.choose_sections(step_base, total, T,
                                             cap_bytes=total // 3 + 64)
    assert len(sec_len) > 1
    blob = framing.pack(states, stream, t_sec, sec_len)
    _, st2, payload, _, _ = framing.parse(blob, 0)
    dt = tables.build_dec_table(nfreqs, layout=lay, slots=False)
    kernel_vs_xla(payload, st2, dt, n, S, big_sparse)


def test_grouped_encode_scan_matches_xla(big_sparse):
    """The prepared (device-resident) encoder reproduces the one-shot
    codec byte for byte under the grouped layout, for a raw alphabet
    (ANS) and a device-mapped fold-7 one."""
    from lane_ans.models.ans import AnsFold
    wide = ((np.arange(60000, dtype=np.uint64) * 52817) % (1 << 22)
            ).astype(np.uint32)
    for name, codec, v in (("ANS", AnsInt(lanes=128), big_sparse),
                           ("ANSfold-7", AnsFold(7, lanes=128), wide)):
        pe = models.prepare_encoder(name, v, lanes=128)
        blob = pe.prelude + pe.to_bytes(*pe())
        assert blob == codec.encode(v), name
        nfreqs, _ = load_prelude(blob)
        assert grouped.use_grouped_layout(nfreqs), name


def test_codec_roundtrip_and_cross_sigma_boundary():
    """End-to-end under the XLA engines on CPU right at the layout
    boundary, and a slim-table materialization check."""
    rng = np.random.default_rng(1)
    # sigma just over the boundary
    vals = np.concatenate([
        np.arange((1 << 13) + 40, dtype=np.uint32),
        (rng.zipf(1.4, size=20000) - 1).clip(0, 8000).astype(np.uint32)])
    for codec in (AnsInt(lanes=128), AnsMsb(lanes=128)):
        blob = codec.encode(vals)
        np.testing.assert_array_equal(codec.decode(blob, len(vals)),
                                      vals)


def test_materialized_slots_match_classic_shape(big_sparse):
    """materialize_slots under a grouped layout yields a permuted but
    self-consistent per-slot table (freq/offset/sym agree with the
    layout's base map)."""
    freqs = np.bincount(big_sparse).astype(np.uint64)
    nfreqs = adjust_freqs(freqs, int(big_sparse.max()), False, 1)
    lay = grouped.build_group_layout(nfreqs)
    dt = tables.build_dec_table(nfreqs, layout=lay, slots=False)
    assert dt.freq is None
    full = tables.materialize_slots(dt)
    M = full.frame_size
    bos = lay.base_of_symbol()
    slots = np.arange(M)
    np.testing.assert_array_equal(
        slots, bos[full.sym] + full.offset)
    np.testing.assert_array_equal(full.freq,
                                  np.asarray(nfreqs)[full.sym])
    # every symbol's slot run is contiguous and frequency-long
    first = np.zeros(len(nfreqs), np.int64)
    np.add.at(first, full.sym, 1)
    np.testing.assert_array_equal(first, np.asarray(nfreqs))


def test_block_runtime_grouped(big_sparse, monkeypatch):
    """BlockCodec over a 4-device mesh on a large alphabet: the XLA scan
    engine, and the decode kernel inside shard_map (interpreted) decode
    the same container."""
    from lane_ans.models import engine
    from lane_ans.ops import lane_kernel
    from lane_ans.parallel import BlockCodec, make_mesh
    codec = BlockCodec("ANS", make_mesh(4), lanes=128)
    blob = codec.encode(big_sparse)
    np.testing.assert_array_equal(codec.decode(blob, len(big_sparse)),
                                  big_sparse)
    monkeypatch.setattr(engine, "choose_engine", lambda S: "kernel")
    monkeypatch.setattr(lane_kernel, "decode", functools.partial(
        lane_kernel.decode, interpret=True))
    kernel_codec = BlockCodec("ANS", make_mesh(4), lanes=128)
    np.testing.assert_array_equal(
        kernel_codec.decode(blob, len(big_sparse)), big_sparse)


def test_grouped_fold_exceptions_codec_level():
    """fold-7 on a wide alphabet pushes the FOLDED sigma past 2^13, so
    the grouped layout engages WITH exception bytes through the public
    codec (this binds the whole fold pipeline end-to-end, decoded by the
    kernel in interpret mode and by the XLA scan)."""
    from lane_ans.models.ans import AnsFold
    v = ((np.arange(60000, dtype=np.uint64) * 52817) % (1 << 22)).astype(
        np.uint32)
    sig = len(np.unique(map_np.fold_map(v, 7)))
    assert sig > (1 << 13), sig
    blob = run_blob("ANSfold-7", AnsFold(7, lanes=256), v)
    nfreqs, _ = load_prelude(blob)
    assert grouped.use_grouped_layout(nfreqs)


def test_grouped_size_parity_with_compat(big_sparse):
    """The grouped layout must not change compression: same freqs ->
    same model bpi; the lane container differs from compat only by the
    state flush + renorm noise (< 3% at this tiny n; the overhead is
    4S bytes, amortized at real sizes)."""
    from lane_ans import models
    lane = models.get("ANS", "lane")
    lane.lanes = 128
    compat = models.get("ANS", "compat")
    bl = lane.encode(big_sparse)
    bc = compat.encode(big_sparse)
    overhead = (len(bl) - len(bc)) / len(bc)
    assert -0.005 < overhead < 0.03, overhead
    np.testing.assert_array_equal(
        compat.decode(bc, len(big_sparse)), big_sparse)


def test_grouped_env_force(monkeypatch, big_sparse):
    """On a GPU backend prepare_decoder stages a grouped blob for the
    kernel (the per-slot tables in the grouped order), on the CPU
    backend for the XLA scan."""
    from lane_ans.models import engine
    blob = AnsInt(lanes=256).encode(big_sparse)
    n = len(big_sparse)
    assert models.prepare_decoder("ANS", blob, n).engine == "xla"
    monkeypatch.setattr(engine.jax, "default_backend", lambda: "gpu")
    prep = models.prepare_decoder("ANS", blob, n)
    assert prep.engine == "kernel"
    nfreqs, _ = load_prelude(blob)
    lay = grouped.build_group_layout(nfreqs)
    # val table = owning symbol per slot, slot runs in rank order
    sym = np.asarray(prep._args[4])
    first = np.r_[0, np.flatnonzero(np.diff(sym)) + 1]
    np.testing.assert_array_equal(sym[first], lay.perm)
