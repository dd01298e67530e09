"""Decode-engine choice + device-resident prepared decoders and encoders.

Call patterns:
  * decode(...)          - one-shot: stage inputs, run, return host array
  * PreparedDecoder(...) - stage tables + stream on device once, then
    every call runs only the decode engine: the serving pattern
    (compressed blocks live in device memory next to the consumer) and
    the device decode benchmark.
  * PreparedEncoder(...) - the same for encode: staged (T, S) inputs and
    tables, every call runs only the lane encode scan + placement.

Engine choice: the fused decode kernel (ops/lane_kernel.py) on a GPU
backend, the XLA scan (ops/lane_codec.decode_lanes) elsewhere.  Both
read the same per-slot tables and produce bit-identical output.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lane_codec, lane_kernel, tables
from . import framing


def choose_engine(S: int) -> str:
    """'kernel' on a GPU backend (for S within the kernel's lane cap),
    'xla' otherwise."""
    return ("kernel" if jax.default_backend() == "gpu"
            and S <= lane_kernel.MAX_LANES else "xla")


class PreparedDecoder:
    """All decode inputs staged on device; call to run the engine.

    engine/interpret are test knobs: an explicit engine bypasses
    choose_engine, and interpret=True runs the kernel in the Pallas
    interpreter on any backend.  Production callers pass neither."""

    def __init__(self, payload: np.ndarray, states: np.ndarray,
                 dt: tables.DecTable, n: int, *, S: int, T: int,
                 has_exc: bool, engine: str | None = None,
                 interpret: bool = False):
        self.n, self.S, self.T = n, S, T
        self.engine = engine or choose_engine(S)
        if self.engine not in ("kernel", "xla"):
            raise ValueError(f"unknown decode engine {self.engine!r}")
        dt = tables.materialize_slots(dt)
        stream = jnp.asarray(np.concatenate([payload,
                                             np.zeros(8, np.uint8)]))
        dummy = jnp.zeros(1, jnp.uint32)
        high = jnp.asarray(dt.high) if has_exc else dummy
        nb = jnp.asarray(dt.nb) if has_exc else dummy
        head = (stream, jnp.asarray(states), jnp.asarray(dt.freq),
                jnp.asarray(dt.offset))
        self._kw = dict(S=S, T=T, log2m=dt.log2m, has_exc=has_exc)
        if self.engine == "kernel":
            # the kernel reads one value table: the symbol, or the high
            # part the exception low bytes are added to
            val = high if has_exc else jnp.asarray(dt.sym)
            self._args = head + (val, nb, jnp.int32(n))
            self._kw["interpret"] = interpret
            self._fn = lane_kernel.decode
        else:
            self._args = head + (jnp.asarray(dt.sym), high, nb,
                                 jnp.int32(n))
            self._fn = lane_codec.decode_lanes

    def __call__(self):
        """Run the engine; returns the device array (T, S)."""
        return self._fn(*self._args, **self._kw)

    def to_host(self, out) -> np.ndarray:
        return np.asarray(out).reshape(-1)[: self.n].astype(np.uint32)


def decode(payload: np.ndarray, states: np.ndarray, dt: tables.DecTable,
           n: int, *, S: int, T: int, has_exc: bool) -> np.ndarray:
    """One-shot: stage, run, and return the trimmed host u32 array."""
    prep = PreparedDecoder(payload, states, dt, n, S=S, T=T,
                           has_exc=has_exc)
    return prep.to_host(prep())


class PreparedEncoder:
    """Device-resident encode: inputs staged (T, S) and tables uploaded;
    every call runs only the lane encode scan + placement
    (lane_codec.encode_lanes), on any backend."""

    def __init__(self, mapped_ts, nb_ts, excb_ts, n: int,
                 et: tables.EncTable, *, S: int, T: int):
        self.n, self.S, self.T = n, S, T
        self._args = (mapped_ts, nb_ts, excb_ts, jnp.int32(n),
                      jnp.asarray(et.freq), jnp.asarray(et.base),
                      jnp.asarray(et.ub))
        self._kw = dict(S=S, T=T, log2m=et.log2m)

    def __call__(self):
        """Returns the device tuple (stream, total, states, step_base)."""
        return lane_codec.encode_lanes(*self._args, **self._kw)

    def to_bytes(self, stream, total, states, step_base) -> bytes:
        """The fmt-2 lane stream (section table included) of one call."""
        return framing.pack_encoded(stream, total, states, step_base,
                                    self.T)
