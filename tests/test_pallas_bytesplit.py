"""Byte-split device kernels (ops/bytesplit: vbyte + streamvbyte) against
plain sequential references.

The wire formats are fixed (vbyte: include/vbyte.hpp 7-bit varints,
reference_model/vbyte; streamvbyte: lemire control+data layout), so
encode must be BYTE-EXACT against the references and decode must invert
real streams, over value lengths 1..5 bytes, ragged n and padded
buffers.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from lane_ans.ops import bytesplit as bs
from lane_ans.reference_model import vbyte as vb_ref


def _mixed(rng, n):
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    m = rng.random(n)
    return np.where(m < .5, x & 0x7F,
                    np.where(m < .8, x & 0xFFFF, x)).astype(np.uint32)


def vbyte_ref(x) -> bytes:
    return b"".join(vb_ref.encode_u32(int(v)) for v in x)


def vbyte_ref_decode(buf: bytes, n: int) -> np.ndarray:
    out, pos = [], 0
    for _ in range(n):
        v, pos = vb_ref.decode_u32(buf, pos)
        out.append(v)
    return np.array(out, dtype=np.uint32)


def svb_ref(x) -> tuple[bytes, bytes]:
    """(control, data): 2-bit (length-1) keys, 4 per control byte, lowest
    key in the low bits; data bytes little-endian, 1..4 per value."""
    lens = [max(1, (int(v).bit_length() + 7) // 8) for v in x]
    keys = lens + [1] * (-len(lens) % 4)
    control = bytes(sum((k - 1) << (2 * i) for i, k in
                        enumerate(keys[j:j + 4]))
                    for j in range(0, len(keys), 4))
    data = b"".join(int(v).to_bytes(ln, "little") for v, ln in zip(x, lens))
    return control, data


def _padded(b: bytes) -> "jnp.ndarray":
    return jnp.asarray(np.frombuffer(b + bytes(8), dtype=np.uint8))


@pytest.mark.parametrize("n", [100, 5000, 70000])
@pytest.mark.parametrize("vbyte", [False, True])
def test_split_encode_byte_exact(n, vbyte):
    x = _mixed(np.random.default_rng(n), n)
    if vbyte:
        out, total = bs.vbyte_encode(jnp.asarray(x))
        assert np.asarray(out[: int(total)]).tobytes() == vbyte_ref(x)
    else:
        control, data, total = bs.svb_encode(jnp.asarray(x))
        c_ref, d_ref = svb_ref(x)
        assert np.asarray(control).tobytes() == c_ref
        assert np.asarray(data[: int(total)]).tobytes() == d_ref


@pytest.mark.parametrize("n", [100, 5000, 70000])
def test_svb_decode_kernel(n):
    x = _mixed(np.random.default_rng(n + 1), n)
    control, data = svb_ref(x)
    out = bs.svb_decode(jnp.asarray(np.frombuffer(control, np.uint8)),
                        _padded(data), n=n)
    np.testing.assert_array_equal(np.asarray(out), x)


@pytest.mark.parametrize("n", [100, 4096, 50000])
def test_vbyte_decode_kernel(n):
    x = _mixed(np.random.default_rng(n + 2), n)
    out = bs.vbyte_decode(_padded(vbyte_ref(x)), n=n)
    np.testing.assert_array_equal(np.asarray(out), x)


@pytest.mark.parametrize("kmax", [1, 2, 3, 4, 5])
def test_vbyte_decode_every_target_density(kmax):
    """Every maximum element length 1..5, including elements shorter
    than the maximum."""
    rng = np.random.default_rng(kmax)
    hi = min((1 << (7 * kmax)) - 1, (1 << 32) - 1)
    x = rng.integers(0, hi + 1, size=9000, dtype=np.uint64).astype(
        np.uint32)
    x[0] = hi  # pin the max length to exactly kmax
    buf = vbyte_ref(x)
    assert max(len(vb_ref.encode_u32(int(v))) for v in x) == kmax
    np.testing.assert_array_equal(vbyte_ref_decode(buf, len(x)), x)
    out = bs.vbyte_decode(_padded(buf), n=len(x))
    np.testing.assert_array_equal(np.asarray(out), x)


def test_svb_decode_every_length():
    """Control keys of every length 1..4, ragged last control byte."""
    x = np.array([0, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFF, 0x1000000,
                  0xFFFFFFFF, 7], dtype=np.uint32)
    control, data = svb_ref(x)
    assert len(control) == 3 and len(data) == 1 + 1 + 2 + 2 + 3 + 3 + 4 \
        + 4 + 1
    out = bs.svb_decode(jnp.asarray(np.frombuffer(control, np.uint8)),
                        _padded(data), n=len(x))
    np.testing.assert_array_equal(np.asarray(out), x)


def test_vbyte_decode_window_alignment():
    """All-5-byte values: every element spans the maximum width."""
    rng = np.random.default_rng(9)
    x = (rng.integers(1 << 28, 1 << 32, size=9000, dtype=np.uint64)
         .astype(np.uint32))
    buf = vbyte_ref(x)
    assert len(buf) == 5 * len(x)
    out = bs.vbyte_decode(_padded(buf), n=len(x))
    np.testing.assert_array_equal(np.asarray(out), x)
