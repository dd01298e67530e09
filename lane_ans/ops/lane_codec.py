"""Lane-format ("ATF" fmt 2) rANS engine: S lanes in lockstep over one
shared byte stream, vectorized and jittable end-to-end (XLA engine here;
the fused GPU decode kernel in lane_kernel.py reads the same format).

Massively-parallel generalization of the reference's 4-state interleave
(reference: ans_int.hpp:212-241 encode, :257-276 decode; ans_fold.hpp
:249-278, :283-310): S lanes, u32 state, 8-bit renormalization.

Lockstep stream discipline (docs/FORMAT.md section 2): at decode step t,
every valid lane's byte requirement is computable BEFORE any byte is
read — the renorm count depends only on the post-update state because
L = 2^23 is a power of two (st needs a j-th byte iff st < L >> 8(j-1),
independent of byte values), and the exception count comes from the
decode table.  Bytes are laid out in six per-step ROUNDS:

    [renorm round 0: the first renorm byte of every lane with rc >= 1,
     lanes ascending] [renorm round 1: rc >= 2] [renorm round 2]
    [exception rounds 0..2 likewise, nb >= j+1], steps ascending.

Within a round, a lane's byte sits at rank(lane) = exclusive prefix sum
of the round's mask — so every stream access is a gather from a window
of <= S bytes past the shared cursor, and the shared stream eliminates
per-lane directories entirely (overhead = 4S state bytes total).

Layout: symbol at position p = t*S + lane is handled by `lane` at step
t.  Arrays are staged (T, S) so `lax.scan` consumes the step axis.

Encode is reverse-order with on-device count-then-place compaction: the
scan records each step's <=6 emitted bytes (<=3 exception + <=3 renorm)
into fixed slots plus their counts; cumulative sums over steps and lanes
compute every byte's final position, and one scatter materializes the
packed stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .tables import A_L

U32 = jnp.uint32
U8 = jnp.uint8


def lane_steps(n: int, S: int) -> int:
    """Steps per lane T = ceil(n / S)."""
    return -(-n // S) if n else 0


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def encode_lanes_impl(mapped, nb, excb, n, freq, base, ub, *, S, T, log2m):
    """Encode staged symbols into one lockstep shared stream.

    mapped: (T, S) u32 mapped symbol ids (pad = 0)
    nb:     (T, S) u32 exception-byte counts (pad = 0)
    excb:   (T, S, 3) u8 stripped low bytes, lowest first (pad = 0)
    n:      scalar i32 actual element count (dynamic)
    freq/base/ub: (sigma,) u32 encoder table (tables.build_enc_table)

    Returns (stream u8 (S*T*6,), total i32, final_states u32 (S,),
    step_base i32 (T,)): the valid stream is the prefix of length
    `total`, and step_base[t] is the byte offset where step t's bytes
    begin — the section-cut table (framing.choose_sections).
    """
    lanes = jnp.arange(S, dtype=jnp.int32)

    def step(state, xs):
        t, sym, nb_t, excb_t = xs
        valid = (t * S + lanes) < n
        s = sym.astype(jnp.int32)
        f = jnp.maximum(freq[s], jnp.uint32(1))
        b = base[s]
        u = ub[s]
        nb_v = jnp.where(valid, nb_t, 0).astype(jnp.int32)
        # renormalize: emit low bytes while state >= ub (needs are a prefix)
        rmask = []
        st = state
        for _ in range(3):
            need = valid & (st >= u)
            rmask.append(need)
            st = jnp.where(need, st >> jnp.uint32(8), st)
        rbytes = []
        stx = state
        for i in range(3):
            rbytes.append((stx & jnp.uint32(0xFF)).astype(U8))
            stx = stx >> jnp.uint32(8)
        # state update: ((state / f) << log2m) + state % f + base
        q = st // f
        r = st - q * f
        new_state = (q << jnp.uint32(log2m)) + r + b
        st = jnp.where(valid, new_state, state)
        rc = sum(m.astype(jnp.int32) for m in rmask)
        out = (rc, nb_v,
               jnp.stack(rbytes, axis=-1),          # (S, 3)
               jnp.stack(rmask, axis=-1),           # (S, 3) bool
               excb_t)                              # (S, 3)
        return st, out

    ts = jnp.arange(T, dtype=jnp.int32)
    init = jnp.full((S,), A_L, dtype=U32)
    # encode walks positions backwards: scan steps T-1 .. 0
    states, (rc, nb_all, rbytes, rmask, excb_all) = jax.lax.scan(
        step, init, (ts, mapped, nb, excb), reverse=True)

    stream, total, step_base = place_stream_parts(
        rmask, rc, nb_all, rbytes, excb_all, S=S, T=T)
    return stream, total, states, step_base


def place_stream_parts(rmask, rc, nb_all, rbytes, excb_all, *, S, T):
    """Count-then-place compaction (lockstep per-round layout).

    Round masks per step: renorm round j <=> rc > j (renorm needs are a
    prefix), exception round j <=> nb > j.  The stream position of a
    lane's byte in round r of step t is
        round_base[t, r] + rank[t, r, lane]
    with rank = exclusive cumsum of the round mask over lanes and
    round_base = running total over all earlier (step, round) pairs.

    rmask: (T,S,3) bool renorm-emission slots; rc/nb_all: (T,S) i32;
    rbytes/excb_all: (T,S,3) u8 (renorm/exception bytes, lowest first).
    Returns (stream u8 (S*T*6,), total, step_base (T,)).
    """
    rmask_i = rmask.astype(jnp.int32)                       # (T, S, 3)
    emask_i = (jnp.arange(3)[None, None, :]
               < nb_all[..., None]).astype(jnp.int32)       # (T, S, 3)
    all_masks = jnp.concatenate([rmask_i, emask_i], axis=-1)  # (T, S, 6)
    rank = jnp.cumsum(all_masks, axis=1) - all_masks        # (T, S, 6)
    round_tot = all_masks.sum(axis=1)                       # (T, 6)
    flat_tot = round_tot.reshape(-1)                        # (T*6,)
    round_base = (jnp.cumsum(flat_tot) - flat_tot).reshape(T, 6)
    total = round_tot.sum()
    TOT = S * T * 6
    stream = jnp.zeros((TOT,), dtype=U8)
    base_b = jnp.broadcast_to(round_base[:, None, :], (T, S, 6))

    def place(stream, slot_mask, rnd, byte):
        rnd = jnp.clip(rnd, 0, 5)[..., None]
        pos = (jnp.take_along_axis(base_b, rnd, axis=2)
               + jnp.take_along_axis(rank, rnd, axis=2))[..., 0]
        idx = jnp.where(slot_mask, pos, TOT)
        return stream.at[idx.reshape(-1)].set(byte.reshape(-1),
                                              mode="drop")

    # decode reads renorm bytes high-first: emission slot i (i-th lowest
    # byte) is read in renorm round rc-1-i
    for i in range(3):
        stream = place(stream, rmask[..., i], rc - 1 - i, rbytes[..., i])
    # exception bytes likewise: emission slot i read in exc round nb-1-i
    for i in range(3):
        stream = place(stream, i < nb_all, 3 + nb_all - 1 - i,
                       excb_all[..., i])
    return stream, total, round_base[:, 0]


encode_lanes = jax.jit(encode_lanes_impl,
                       static_argnames=("S", "T", "log2m"))


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def decode_lanes_impl(stream, init_states, dfreq, doffset, dsym,
                      dhigh, dnb, n, *, S, T, log2m, has_exc):
    """Decode T steps of S lockstep lanes from the shared stream.

    stream:      (B,) u8 shared stream (+ >= 8 pad bytes)
    init_states: (S,) u32 final encoder states
    dfreq/doffset/dsym[/dhigh/dnb]: (M,) u32 decode table
    n: scalar i32 element count

    Returns (T, S) u32 values; flatten()[: n] is the output sequence.
    """
    mask = jnp.uint32((1 << log2m) - 1)
    lanes = jnp.arange(S, dtype=jnp.int32)
    L = jnp.uint32(A_L)

    def step(carry, t):
        state, cursor = carry
        valid = (t * S + lanes) < n
        slot = (state & mask).astype(jnp.int32)
        f = dfreq[slot]
        off = doffset[slot]
        st0 = f * (state >> jnp.uint32(log2m)) + off
        st0 = jnp.where(valid, st0, state)
        # byte requirements are known before any read (L is 2^23):
        rc = ((st0 < L).astype(jnp.int32)
              + (st0 < (L >> jnp.uint32(8))).astype(jnp.int32)
              + (st0 < (L >> jnp.uint32(16))).astype(jnp.int32))
        rc = jnp.where(valid, rc, 0)
        if has_exc:
            k = jnp.where(valid, dnb[slot], 0).astype(jnp.int32)
        else:
            k = jnp.zeros_like(rc)
        # per-round reads: round mask -> rank via prefix sum -> gather
        st = st0
        for j in range(3):
            take = j < rc
            ti = take.astype(jnp.int32)
            rank = jnp.cumsum(ti) - ti
            byte = stream[cursor + rank].astype(U32)
            st = jnp.where(take, (st << jnp.uint32(8)) | byte, st)
            cursor = cursor + jnp.sum(ti)
        if has_exc:
            low = jnp.zeros((S,), U32)
            for j in range(3):
                take = j < k
                ti = take.astype(jnp.int32)
                rank = jnp.cumsum(ti) - ti
                byte = stream[cursor + rank].astype(U32)
                low = jnp.where(take, (low << jnp.uint32(8)) | byte, low)
                cursor = cursor + jnp.sum(ti)
            val = dhigh[slot] + low
        else:
            val = dsym[slot]
        return (st, cursor), val

    ts = jnp.arange(T, dtype=jnp.int32)
    (_, _), out = jax.lax.scan(step, (init_states, jnp.int32(0)), ts)
    return out


decode_lanes = jax.jit(decode_lanes_impl,
                       static_argnames=("S", "T", "log2m", "has_exc"))
