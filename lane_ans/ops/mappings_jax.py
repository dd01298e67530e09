"""Device-side (jnp) symbol mappings: msb bucketing and generalized fold.

jnp twins of lane_ans.reference_model.mappings (which documents the
reference provenance: ans_msb.hpp:41-50, ans_fold.hpp:38-65).  These run
on device so the map+histogram pass of the two-pass pipeline never leaves
the device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import fold_offset_step, fold_threshold

U32 = jnp.uint32


def msb_map(x):
    x = x.astype(U32)
    return jnp.where(
        x <= 256, x,
        jnp.where(x <= (1 << 16), (x >> U32(8)) + U32(256),
                  jnp.where(x <= (1 << 24), (x >> U32(16)) + U32(512),
                            (x >> U32(24)) + U32(768)))).astype(U32)


def msb_exception_bytes(bucket):
    b = bucket.astype(U32)
    return ((b > 256).astype(U32) + (b > 512).astype(U32)
            + (b > 768).astype(U32))


def fold_exception_count(x, fidelity: int):
    x = x.astype(U32)
    thres = U32(fold_threshold(fidelity))
    k = jnp.zeros(x.shape, U32)
    for i in range(1, 4):
        k += ((x >> U32(8 * (i - 1))) >= thres).astype(U32)
    return k


def fold_map(x, fidelity: int):
    x = x.astype(U32)
    k = fold_exception_count(x, fidelity)
    step = U32(fold_offset_step(fidelity))
    return ((x >> (U32(8) * k)) + step * k).astype(U32)


def low_bytes(x):
    """(n, 3) u8 of the three low bytes of x, lowest first (the exception
    byte pool; only the first k per element are emitted)."""
    x = x.astype(U32)
    return jnp.stack(
        [(x & U32(0xFF)).astype(jnp.uint8),
         ((x >> U32(8)) & U32(0xFF)).astype(jnp.uint8),
         ((x >> U32(16)) & U32(0xFF)).astype(jnp.uint8)], axis=-1)


@functools.partial(jax.jit, static_argnames=("fidelity", "length"))
def fold_map_hist(x, *, fidelity: int, length: int):
    """Fused map + exception extraction + histogram (one device pass)."""
    mapped = fold_map(x, fidelity)
    k = fold_exception_count(x, fidelity)
    b = low_bytes(x)
    hist = jnp.bincount(mapped, length=length)
    return mapped, k, b, hist


@functools.partial(jax.jit, static_argnames=("length",))
def msb_map_hist(x, *, length: int):
    mapped = msb_map(x)
    k = msb_exception_bytes(mapped)
    b = low_bytes(x)
    hist = jnp.bincount(mapped, length=length)
    return mapped, k, b, hist
