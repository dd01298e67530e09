"""Multi-device block runtime tests on the virtual 8-device CPU mesh.

The reference offers no distributed mode to mirror (SURVEY.md section 4
item c): these tests assert the net-new guarantees — round-trip through
the ATFB container, determinism across mesh sizes, and single-device
equivalence of the shared-model pipeline.
"""

import functools

import numpy as np
import pytest

from lane_ans.parallel import BlockCodec, make_mesh


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return (rng.zipf(1.3, size=40000) - 1).clip(0, 1 << 27).astype(
        np.uint32)


@pytest.mark.parametrize("method", ["ANSfold-2", "ANSmsb", "ANS"])
def test_blocked_roundtrip(data, method):
    src = data if method != "ANS" else (data % 4096).astype(np.uint32)
    codec = BlockCodec(method, make_mesh(8), lanes=32)
    blob = codec.encode(src)
    np.testing.assert_array_equal(codec.decode(blob, len(src)), src)


def test_blocked_n_from_container(data):
    codec = BlockCodec("ANSfold-2", make_mesh(8), lanes=32)
    blob = codec.encode(data)
    np.testing.assert_array_equal(codec.decode(blob), data)


def test_mesh_size_changes_sections_not_values(data):
    """1-device and 8-device meshes produce different containers but
    identical decoded output (and the same shared model/prelude)."""
    import struct
    c1 = BlockCodec("ANSfold-2", make_mesh(1), lanes=32)
    c8 = BlockCodec("ANSfold-2", make_mesh(8), lanes=32)
    b1, b8 = c1.encode(data), c8.encode(data)
    np.testing.assert_array_equal(c1.decode(b1), c8.decode(b8))
    # shared prelude identical: same global histogram -> same model
    (p1,) = struct.unpack_from("<I", b1, 16)
    (p8,) = struct.unpack_from("<I", b8, 16)
    assert p1 == p8 and b1[20:20 + p1] == b8[20:20 + p8]


def test_ragged_tail(data):
    """n not divisible by D: short last section."""
    codec = BlockCodec("ANSmsb", make_mesh(8), lanes=32)
    src = data[: 8 * 4999 + 3]
    np.testing.assert_array_equal(codec.decode(codec.encode(src)), src)


def test_graft_entry_dryrun():
    import __graft_entry__ as g
    import jax

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[0] * out.shape[1] >= 4096
    g.dryrun_multichip(8)


# -- the per-device decode kernel inside shard_map ---------------------------

@pytest.fixture
def kernel_engine(monkeypatch):
    """Route BlockCodec's per-device decode through the fused kernel, in
    the Pallas interpreter (the CPU mesh has no GPU to compile for)."""
    from lane_ans.models import engine
    from lane_ans.ops import lane_kernel
    monkeypatch.setattr(engine, "choose_engine", lambda S: "kernel")
    monkeypatch.setattr(lane_kernel, "decode", functools.partial(
        lane_kernel.decode, interpret=True))


@pytest.mark.parametrize("method", ["ANSfold-2", "ANSmsb", "ANS",
                                    "ANSrfold-1", "ANSsint-2",
                                    "ANSsmsb-80"])
def test_blocked_pallas_roundtrip(data, method, kernel_engine):
    """shard_map decode bodies run the fused decode kernel."""
    src = data if "sint" not in method and method != "ANS" else (
        data % 4096).astype(np.uint32)
    codec = BlockCodec(method, make_mesh(8), lanes=128)
    blob = codec.encode(src[:20000])
    np.testing.assert_array_equal(codec.decode(blob, 20000), src[:20000])


def test_blocked_engines_cross_decode(data, monkeypatch):
    """One container, both per-device engines: the XLA scan and the
    decode kernel decode it identically."""
    src = data[:20000]
    codec = BlockCodec("ANSfold-2", make_mesh(4), lanes=128)
    blob = codec.encode(src)
    np.testing.assert_array_equal(codec.decode(blob, len(src)), src)
    from lane_ans.models import engine
    from lane_ans.ops import lane_kernel
    monkeypatch.setattr(engine, "choose_engine", lambda S: "kernel")
    monkeypatch.setattr(lane_kernel, "decode", functools.partial(
        lane_kernel.decode, interpret=True))
    np.testing.assert_array_equal(
        BlockCodec("ANSfold-2", make_mesh(4), lanes=128).decode(
            blob, len(src)), src)


def test_blocked_pallas_ragged(data, kernel_engine):
    src = data[: 8 * 2381 + 5]
    codec = BlockCodec("ANSmsb", make_mesh(8), lanes=128)
    np.testing.assert_array_equal(codec.decode(codec.encode(src)), src)


def test_blocked_model_independent_of_padding_and_mesh():
    """The shared model must reflect the DATA histogram: the device
    pass histograms zero-padded shards, and the padding counts are
    subtracted (regression: up to D-1 phantom symbol-0 counts made the
    wire bytes depend on the mesh size)."""
    import struct
    from lane_ans.parallel import BlockCodec, make_mesh
    rng = np.random.default_rng(11)
    v = (rng.zipf(1.5, 4001) - 1).clip(0, 1 << 16).astype(np.uint32) + 1
    def prelude_of(blob):
        (plen,) = struct.unpack_from("<I", blob, 16)
        return blob[20:20 + plen]
    blobs = {}
    for D in (1, 4):
        codec = BlockCodec("ANSmsb", make_mesh(D), lanes=32)
        blob = codec.encode(v)
        np.testing.assert_array_equal(codec.decode(blob), v)
        blobs[D] = prelude_of(blob)
    assert blobs[1] == blobs[4]


def test_blocked_decode_rejects_wrong_n():
    from lane_ans.parallel import BlockCodec, make_mesh
    import pytest
    rng = np.random.default_rng(12)
    v = (rng.zipf(1.5, 2000) - 1).clip(0, 1 << 16).astype(np.uint32)
    codec = BlockCodec("ANSfold-2", make_mesh(4), lanes=32)
    blob = codec.encode(v)
    with pytest.raises(ValueError, match="prefix"):
        codec.decode(blob, len(v) - 100)
    np.testing.assert_array_equal(codec.decode(blob, len(v)), v)
