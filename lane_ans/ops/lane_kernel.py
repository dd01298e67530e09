"""Fused lane-format decode kernel for NVIDIA GPUs (Pallas through Triton).

Decodes one fmt-2 lockstep stream (docs/FORMAT.md section 2) in one
kernel launch: the S lane states and the shared stream cursor stay in
registers for all T steps, where the XLA engine (lane_codec.decode_lanes)
runs a `lax.scan` whose every step is several device kernels with the
carry round-tripping through device memory.

One program decodes one stream, its S lanes forming the block vector.
Per step:

  * gather freq / offset (and the exception count) of each lane's slot
    from the per-slot decode tables (tables.materialize_slots — the same
    tables the XLA engine reads, under every slot layout);
  * update the states and derive all six round masks before any byte is
    read (renorm needs depend only on the updated state, L = 2^23 being a
    power of two; exception counts come from the table);
  * rank each lane within its rounds with integer exclusive prefix sums,
    two rounds packed per 32-bit word (16-bit fields: a count is <= S <=
    2^14, so the fields never carry into each other);
  * gather the stream bytes at cursor + round base + rank, fold them into
    the states and the exception low bits, advance the cursor;
  * store row t of the (T, S) output.

All arithmetic is exact 32-bit integer arithmetic, bit-identical to the
XLA engine.  The kernel reads the contiguous payload, so blobs with and
without fmt-2 section cuts decode the same way.

`interpret=True` runs the kernel in the Pallas interpreter on any backend
(the CPU tests); otherwise it compiles for the GPU through Triton.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .tables import A_L

U32 = jnp.uint32

# the kernel's lane vector: padded up to a whole number of warps, and
# capped so two 16-bit rank fields share one int32 prefix sum (their
# packed total stays below 2^31)
MIN_LANES = 32
MAX_LANES = 1 << 14


def padded_lanes(S: int) -> int:
    """Block width for an S-lane stream (S is a power of two)."""
    if S > MAX_LANES:
        raise ValueError(f"decode kernel supports S <= {MAX_LANES}, "
                         f"got S={S}")
    return max(S, MIN_LANES)


def num_warps(Sp: int) -> int:
    """Warps per program: about 128 lanes per warp, 4..32 warps."""
    return min(32, max(4, Sp // 128))


def _kernel(n_ref, states_ref, stream_ref, freq_ref, off_ref, val_ref,
            nb_ref, out_ref, *, S, T, log2m, has_exc):
    Sp = states_ref.shape[0]
    lanes = jax.lax.broadcasted_iota(jnp.int32, (Sp,), 0)
    n = n_ref[0]
    mask = U32((1 << log2m) - 1)
    L = U32(A_L)

    def ranks(lo, hi):
        """Exclusive per-lane ranks and totals of two rounds at once."""
        w = lo.astype(jnp.int32) | (hi.astype(jnp.int32) << 16)
        ex = jnp.cumsum(w) - w
        tot = jnp.sum(w)
        return ((ex & 0xFFFF, ex >> 16), (tot & 0xFFFF, tot >> 16))

    def read(take, pos):
        return stream_ref[jnp.where(take, pos, 0)].astype(U32)

    def step(t, carry):
        state, cursor = carry
        valid = (lanes < S) & (t * S + lanes < n)
        slot = (state & mask).astype(jnp.int32)
        st0 = freq_ref[slot] * (state >> U32(log2m)) + off_ref[slot]
        st0 = jnp.where(valid, st0, state)
        rc = jnp.where(valid,
                       ((st0 < L).astype(jnp.int32)
                        + (st0 < (L >> U32(8))).astype(jnp.int32)
                        + (st0 < (L >> U32(16))).astype(jnp.int32)), 0)
        takes = [rc > 0, rc > 1, rc > 2]
        if has_exc:
            k = jnp.where(valid, nb_ref[slot], U32(0)).astype(jnp.int32)
            takes += [k > 0, k > 1, k > 2]
        pairs = [ranks(takes[i], takes[i + 1] if i + 1 < len(takes)
                       else jnp.zeros_like(takes[i]))
                 for i in range(0, len(takes), 2)]
        rank = [r for (rr, _) in pairs for r in rr]
        count = [c for (_, cc) in pairs for c in cc]
        base = cursor
        st = st0
        low = jnp.zeros((Sp,), U32)
        for j, take in enumerate(takes):
            byte = read(take, base + rank[j])
            if j < 3:
                st = jnp.where(take, (st << U32(8)) | byte, st)
            else:
                low = jnp.where(take, (low << U32(8)) | byte, low)
            base = base + count[j]
        out_ref[t, :] = val_ref[slot] + low if has_exc else val_ref[slot]
        return st, base

    jax.lax.fori_loop(0, T, step, (states_ref[...], jnp.int32(0)))


@functools.partial(jax.jit, static_argnames=("S", "T", "log2m", "has_exc",
                                             "interpret"))
def decode(stream, states, freq, offset, val, nb, n, *, S, T, log2m,
           has_exc, interpret=False):
    """Decode T steps of S lockstep lanes; same contract as
    lane_codec.decode_lanes.

    stream: (B,) u8 shared stream (+ >= 8 pad bytes)
    states: (S,) u32 final encoder states
    freq/offset: (M,) u32 per-slot tables; val: (M,) u32 symbol (or the
    exception coders' high part); nb: (M,) u32 exception byte counts
    (any (1,) array when has_exc is False)
    n: scalar i32 element count

    Returns (T, S) u32; flatten()[: n] is the output sequence.
    """
    Sp = padded_lanes(S)
    states = jnp.pad(states.astype(U32), (0, Sp - S))
    kern = functools.partial(_kernel, S=S, T=T, log2m=log2m,
                             has_exc=has_exc)
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((T, Sp), U32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps(Sp),
                                                 num_stages=1),
        interpret=interpret,
        name="lane_decode",
    )(jnp.reshape(n, (1,)).astype(jnp.int32), states, stream, freq,
      offset, val, nb)
    return out[:, :S]
