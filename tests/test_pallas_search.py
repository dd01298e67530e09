"""Fused decode kernel over every decode-table shape (interpreter mode).

The kernel reads the same per-slot tables as the XLA scan engine
(tables.materialize_slots) under every coder: fold/msb (exceptions),
dense and sparse identity ans_int, uncapped frames, high words >= 2^30,
frames with log2m > 16 (3 renorm rounds), multi-section streams and a
single-symbol alphabet.  Each case must match the XLA scan bit for bit
and reproduce the input; plus the engine choice and the kernel's
lowering for a CUDA device.
"""

import functools

import numpy as np
import pytest

from lane_ans import models
from lane_ans.models import framing
from lane_ans.models.ans import AnsFold, AnsInt, AnsMsb
from lane_ans.ops import lane_kernel, tables
from lane_ans.reference_model import mappings as map_np
from lane_ans.reference_model.model import adjust_freqs, load_prelude

from kernel_cases import encode_staged, kernel_vs_xla, run_blob


@pytest.fixture(scope="module")
def zdata():
    rng = np.random.default_rng(5)
    return (rng.zipf(1.3, size=40000) - 1).clip(0, 1 << 27).astype(
        np.uint32)


def test_search_fold(zdata):
    run_blob("ANSfold-2", AnsFold(2, lanes=256), zdata)


def test_search_msb(zdata):
    run_blob("ANSmsb", AnsMsb(lanes=128), zdata[:20000])


def test_search_int_identity(zdata):
    """Every symbol 0..511 present: the symbol IS the value."""
    v = (zdata % 512).astype(np.uint32)
    blob = run_blob("ANS", AnsInt(lanes=128), v)
    nfreqs, _ = load_prelude(blob)
    assert (np.asarray(nfreqs) > 0).all()


def test_search_int_sparse_val_table(zdata):
    """Gaps in the alphabet: absent symbols own no slots."""
    sparse = (zdata % 300).astype(np.uint32) * 7 + 3
    blob = run_blob("ANS", AnsInt(lanes=128), sparse)
    nfreqs, _ = load_prelude(blob)
    assert (np.asarray(nfreqs) == 0).any()


def test_search_int_uncapped_frame(zdata):
    """max_frame=None: reference-exact frames."""
    blob = run_blob("ANS", AnsInt(lanes=128, max_frame=None),
                    (zdata % 3000).astype(np.uint32))
    nfreqs, _ = load_prelude(blob)
    assert int(np.asarray(nfreqs).sum()) > (1 << 14)


def test_search_ragged_tail(zdata):
    run_blob("ANSfold-1", AnsFold(1, lanes=128), zdata[: 128 * 37 + 5])


def test_search_unpacked_high():
    """high values >= 2^30 (rfold most-frequent remaps can put arbitrary
    u32 values in high): the kernel adds them unpacked."""
    rng = np.random.default_rng(11)
    values = rng.integers(0, 200, size=20000).astype(np.uint32)
    blob = AnsInt(lanes=128).encode(values)
    nfreqs, plen = load_prelude(blob)
    syms = np.arange(len(nfreqs), dtype=np.uint32)
    # pretend decode mapping: value = high[sym] (nb=0), with big highs
    dt = tables.build_dec_table(nfreqs, syms + np.uint32(3 << 30),
                                np.zeros_like(syms))
    S, states, payload, _, _ = framing.parse(blob, plen)
    kernel_vs_xla(payload, states, dt, len(values), S,
                  values + np.uint32(3 << 30))


def test_search_three_renorm_rounds():
    """log2m > 16 makes some steps read 3 renorm bytes; the frame is
    built by hand (adjust_freqs rarely picks one this large for small
    inputs)."""
    rng = np.random.default_rng(13)
    sigma = 4096
    values = rng.integers(0, sigma, size=50000).astype(np.uint32)
    nfreqs = np.full(sigma, 32, dtype=np.uint64)  # M = 2^17
    n = len(values)
    stream, total, states, sb, T = encode_staged(
        values, np.zeros(n, np.uint32), np.zeros((n, 3), np.uint8),
        nfreqs, 128)
    dt = tables.build_dec_table(nfreqs)
    assert dt.log2m == 17
    kernel_vs_xla(stream, states, dt, n, 128, values)


def test_search_multi_section(zdata):
    """Small section cap forces several sections; the msb coder's
    exception bytes cross the cuts too."""
    values = zdata[:30000]
    S = 128
    mapped = map_np.msb_map(values)
    k = map_np.msb_exception_bytes(mapped)
    b = np.stack([(values >> (8 * i)) & 0xFF for i in range(3)],
                 axis=1).astype(np.uint8)
    freqs = np.bincount(mapped).astype(np.uint64)
    nfreqs = adjust_freqs(freqs, len(freqs) - 1, True, 1)
    syms = np.arange(len(nfreqs), dtype=np.uint32)
    dt = tables.build_dec_table(nfreqs, map_np.msb_unmap_high(syms),
                                map_np.msb_exception_bytes(syms))
    stream, total, states, sb, T = encode_staged(mapped, k, b, nfreqs, S)
    t_sec, sec_len = framing.choose_sections(sb, total, T, cap_bytes=8192)
    assert len(sec_len) > 2
    blob = framing.pack(states, stream, t_sec, sec_len)
    _, st2, payload, _, _ = framing.parse(blob, 0)
    kernel_vs_xla(payload, st2, dt, len(values), S, values)


def test_single_symbol_alphabet():
    """sigma == 1: f == M, zero-bit symbols, no stream bytes."""
    values = np.full(5000, 7, dtype=np.uint32)
    run_blob("ANS", AnsInt(lanes=128), values)


@pytest.mark.parametrize("backend,S,want", [
    ("cpu", 4096, "xla"), ("gpu", 4096, "kernel"), ("gpu", 32, "kernel"),
    ("gpu", lane_kernel.MAX_LANES, "kernel"),
    ("gpu", 2 * lane_kernel.MAX_LANES, "xla"), ("cpu", 32, "xla")])
def test_engine_cost_model(monkeypatch, backend, S, want):
    """Engine choice: the kernel on a GPU backend within its lane cap,
    the XLA scan otherwise."""
    from lane_ans.models import engine
    monkeypatch.setattr(engine.jax, "default_backend", lambda: backend)
    assert engine.choose_engine(S) == want


def test_engine_env_force_ineligible_falls_back(zdata):
    """An explicit engine must be a real one: unknown names raise
    instead of silently picking another engine."""
    blob = AnsInt(lanes=128).encode(zdata[:2000] % 100)
    with pytest.raises(ValueError, match="unknown decode engine"):
        models.prepare_decoder("ANS", blob, 2000, engine="search")
    prep = models.prepare_decoder("ANS", blob, 2000)
    assert prep.engine == "xla"  # the CPU backend's engine


@pytest.mark.parametrize("S,has_exc", [(1, False), (256, True),
                                        (4096, True), (4096, False),
                                        (lane_kernel.MAX_LANES, True)])
def test_union_window_path_matches_split(S, has_exc):
    """The kernel lowers through Triton for a CUDA device (checked here
    without one): one `lane_decode` call with the warps policy's count."""
    import jax
    import jax.numpy as jnp
    T, M = 4, 1 << 12
    u32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.uint32)
    args = (jax.ShapeDtypeStruct((6 * T * S + 8,), jnp.uint8), u32(S),
            u32(M), u32(M), u32(M), u32(M if has_exc else 1),
            jax.ShapeDtypeStruct((), jnp.int32))
    text = jax.jit(functools.partial(
        lane_kernel.decode, S=S, T=T, log2m=12, has_exc=has_exc)).trace(
        *args).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("xla.gpu.triton") == 1
    assert 'name = "lane_decode"' in text
    warps = lane_kernel.num_warps(lane_kernel.padded_lanes(S))
    assert f"num_warps = {warps} : i32" in text
