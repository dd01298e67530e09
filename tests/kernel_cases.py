"""Shared helpers for the decode-kernel tests: run the fused kernel in
the Pallas interpreter beside the XLA scan engine and compare."""

import jax.numpy as jnp
import numpy as np

from lane_ans import models
from lane_ans.models.engine import PreparedDecoder
from lane_ans.ops import lane_codec, tables


def kernel_vs_xla(payload, states, dt, n, S, values):
    """Decode with the kernel (interpreted) and the XLA scan; both must
    agree on the whole (T, S) output and reproduce `values`."""
    T = lane_codec.lane_steps(n, S)
    outs = []
    for engine in ("kernel", "xla"):
        prep = PreparedDecoder(payload, states, dt, n, S=S, T=T,
                               has_exc=dt.has_exc, engine=engine,
                               interpret=engine == "kernel")
        assert prep.engine == engine
        outs.append(np.asarray(prep()))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0].reshape(-1)[:n], values)


def run_blob(name, codec, values):
    """Kernel vs XLA on a codec's blob through models.prepare_decoder."""
    blob = codec.encode(values)
    n = len(values)
    kern = models.prepare_decoder(name, blob, n, engine="kernel",
                                  interpret=True)
    xla = models.prepare_decoder(name, blob, n, engine="xla")
    ko = np.asarray(kern())
    np.testing.assert_array_equal(ko, np.asarray(xla()))
    np.testing.assert_array_equal(kern.to_host(ko), values)
    return blob


def encode_staged(mapped, k, b, nfreqs, S, layout=None):
    """XLA lane encode of host-mapped inputs; returns (stream, total,
    states, step_base, T)."""
    et = tables.build_enc_table(nfreqs, layout)
    n = len(mapped)
    T = lane_codec.lane_steps(n, S)
    pad = T * S - n
    stream, total, states, sb = lane_codec.encode_lanes(
        jnp.asarray(np.pad(mapped, (0, pad)).reshape(T, S)),
        jnp.asarray(np.pad(k, (0, pad)).reshape(T, S)),
        jnp.asarray(np.pad(b, ((0, pad), (0, 0))).reshape(T, S, 3)),
        jnp.int32(n), jnp.asarray(et.freq), jnp.asarray(et.base),
        jnp.asarray(et.ub), S=S, T=T, log2m=et.log2m)
    total = int(total)
    return (np.asarray(stream[:total]), total, np.asarray(states),
            np.asarray(sb), T)
