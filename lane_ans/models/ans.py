"""Lane-engine ANS codec family (the device counterparts of
reference include/ans_int.hpp, ans_msb.hpp, ans_fold.hpp,
ans_reorder_fold.hpp, ans_sint.hpp, ans_smsb.hpp).

Pipeline per block (two-pass semi-static, reference call stack
SURVEY.md section 3.1, rebuilt for the accelerator):
  1. map + exception extraction + histogram  - one fused device pass
  2. adjust_freqs frame search               - host float64 (bit-exact
     with the compat model, so preludes are byte-identical to compat)
  3. prelude serialization                   - host (tiny, interp-coded)
  4. S-lane stream coding                    - device (ops.lane_codec)

The wire format is the lane format of docs/FORMAT.md: compat method
header + prelude, then S independent per-lane substreams.
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np

from ..constants import (A_MAX_FRAME_LOG2, MSB_MAX_SIGMA, fold_max_sigma,
                         fold_threshold)
from ..ops import lane_codec, mappings_jax as mj, tables
from ..reference_model import mappings as map_np
from ..reference_model.model import (adjust_freqs, load_prelude,
                                     serialize_prelude)
from ..utils.stats import record_stats
from . import config, framing

U32 = jnp.uint32

# default frame cap for lane codecs: None = the reference's exact
# adjust_freqs search (pass max_frame to trade size for smaller decode
# tables explicitly)
DEFAULT_MAX_FRAME = None

# the lane format's own frame ceiling (renorm byte-needs must be
# computable before reading: log2m + 8 <= log2 L + 2, constants.py).
# None means "honest search, bounded only by what the format can
# represent" — without this clamp zipf-2^20-shaped data (honest frame
# 2^23) raises at encode; WITH it the search stops one doubling early
# and costs ~0.1% bpi.  The compat engine stays truly uncapped.
LANE_FRAME_LIMIT = 1 << A_MAX_FRAME_LOG2


def lane_frame_cap(max_frame: int | None) -> int:
    return LANE_FRAME_LIMIT if max_frame is None else max_frame


# --------------------------------------------------------------------------
# shared stream helpers
# --------------------------------------------------------------------------

def _encode_stream(mapped_dev, nb_dev, excb_dev, n: int, nfreqs,
                   lanes: int | None, layout=None) -> bytes:
    """layout: grouped.GroupLayout when the prelude freqs select the
    frequency-grouped slot order (ops/grouped.use_grouped_layout —
    decoders re-derive it, so it is format, not a knob); the encode
    table's per-symbol bases then follow that order."""
    S = lanes or config.default_lane_count(n)
    T = lane_codec.lane_steps(n, S)
    et = tables.build_enc_table(nfreqs, layout)
    mapped_ts, nb_ts, excb_ts = _stage_ts(mapped_dev, nb_dev, excb_dev,
                                          n, S, T)
    from .engine import PreparedEncoder
    pe = PreparedEncoder(mapped_ts, nb_ts, excb_ts, n, et, S=S, T=T)
    return pe.to_bytes(*pe())


def _decode_stream(buf: bytes, off: int, n: int,
                   dt: tables.DecTable) -> np.ndarray:
    S, states, payload, _, _ = framing.parse(buf, off)
    T = lane_codec.lane_steps(n, S)
    from . import engine as _engine
    return _engine.decode(payload, states, dt, n, S=S, T=T,
                          has_exc=dt.has_exc)


def _stage_ts(mapped_dev, nb_dev, excb_dev, n, S, T):
    """Pad-and-reshape encode inputs to (T,S) lane order.  Shared by the
    one-shot encode path and PreparedEncoder staging
    (models.prepare_encoder)."""
    pad = T * S - n
    if nb_dev is None:
        nb_ts = jnp.zeros((T, S), U32)
        excb_ts = jnp.zeros((T, S, 3), jnp.uint8)
    else:
        nb_ts = jnp.pad(nb_dev, (0, pad)).reshape(T, S)
        excb_ts = jnp.pad(excb_dev, ((0, pad), (0, 0))).reshape(T, S, 3)
    mapped_ts = jnp.pad(jnp.asarray(mapped_dev), (0, pad)).reshape(T, S)
    return mapped_ts, nb_ts, excb_ts


def _maybe_layout(nfreqs):
    """The frequency-grouped slot layout when the prelude freqs select
    it (a format decision both coder sides derive identically)."""
    from ..ops import grouped
    if grouped.use_grouped_layout(nfreqs):
        return grouped.build_group_layout(nfreqs)
    return None


def _int_dec_table(nfreqs) -> tables.DecTable:
    """Decode table for the identity coders (ans/sint): tail-escape
    recoding when the prelude freqs select it (ops/escape.py — the same
    pure derivation the encoder ran), grouped/value-cumulative layout
    otherwise.  Shared by AnsInt._dec_table and the blocked runtime."""
    from ..ops import escape
    plan = escape.plan_from_freqs(nfreqs)
    if plan is not None:
        layout = _maybe_layout(plan.frame_freqs)
        return tables.build_dec_table(plan.frame_freqs, plan.sym_high,
                                      plan.sym_nb, layout=layout,
                                      slots=False)
    layout = _maybe_layout(nfreqs)
    return tables.build_dec_table(nfreqs, layout=layout,
                                  slots=layout is None)


def _encode_via_inputs(codec, values) -> bytes:
    """Shared encode body: model half (codec._enc_inputs) -> prelude ->
    lane stream, with the reference's prelude/encode time split (the
    grouped slot layout builds after the t1 stamp: it is table/encode
    work, like the reference's frame init).  _enc_inputs returns
    (mapped, k, b, prelude_freqs, frame_freqs, header); the two
    frequency vectors differ only under tail-escape recoding
    (ops/escape.py), where the prelude stays the true per-symbol vector
    and the frame runs over the folded alphabet."""
    t0 = time.perf_counter_ns()
    mapped, k, b, pfreqs, ffreqs, header = codec._enc_inputs(values)
    prelude = serialize_prelude(pfreqs, int(pfreqs.sum()))
    t1 = time.perf_counter_ns()
    stream = _encode_stream(mapped, k, b, int(mapped.shape[0]), ffreqs,
                            codec.lanes, layout=_maybe_layout(ffreqs))
    record_stats(prelude_bytes=len(header) + len(prelude),
                 encode_bytes=len(stream), prelude_time_ns=t1 - t0,
                 encode_time_ns=time.perf_counter_ns() - t1)
    return header + prelude + stream


def _require_nonempty(values):
    if len(values) == 0:
        raise ValueError("cannot encode an empty sequence")


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------

class AnsInt:
    """Large-alphabet rANS directly over u32 symbols (reference:
    ans_int.hpp:38-306), S-lane stream."""

    def __init__(self, h_approx: int = 1, lanes: int | None = None,
                 max_frame: int | None = DEFAULT_MAX_FRAME):
        self.h_approx = h_approx
        self.lanes = config.validate_lanes(lanes)
        self.max_frame = max_frame
        self.name = "ANS" if h_approx == 1 else f"ANSsint-{h_approx}"

    def _enc_inputs(self, values):
        """(mapped, nb, excb, prelude_freqs, frame_freqs, header) — the
        model/mapping half of encode(), shared with
        models.prepare_encoder.  Huge live alphabets take the
        tail-escape recoding (ops/escape.py): the frame then runs over
        the folded alphabet while the prelude keeps the true per-symbol
        vector."""
        values = np.ascontiguousarray(values, dtype=np.uint32)
        _require_nonempty(values)
        max_sym = int(values.max())
        freqs = np.bincount(values, minlength=max_sym + 1).astype(np.uint64)
        nfreqs = adjust_freqs(freqs, max_sym, False, self.h_approx,
                              lane_frame_cap(self.max_frame))
        from ..ops import escape
        plan = escape.plan_from_freqs(nfreqs)
        if plan is not None:
            mapped, k, b = plan.map_values(values)
            return mapped, k, b, nfreqs, plan.frame_freqs, b""
        return values, None, None, nfreqs, nfreqs, b""

    def encode(self, values) -> bytes:
        return _encode_via_inputs(self, values)

    def _dec_table(self, buf: bytes):
        """(DecTable, stream offset) parsed from the wire prelude —
        the decode half shared by decode() and prepare_decoder()."""
        nfreqs, plen = load_prelude(buf)
        return _int_dec_table(nfreqs), plen

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        dt, off = self._dec_table(buf)
        return _decode_stream(buf, off, n, dt)


class AnsSint(AnsInt):
    """reference: ans_sint.hpp - AnsInt with the H_approx knob exposed."""

    def __init__(self, h_approx: int, lanes: int | None = None):
        super().__init__(h_approx, lanes)


class AnsMsb:
    """Magnitude-bucketed rANS with exception bytes (reference:
    ans_msb.hpp:41-322), S-lane stream."""

    def __init__(self, h_approx: int = 1, lanes: int | None = None,
                 max_frame: int | None = DEFAULT_MAX_FRAME):
        self.h_approx = h_approx
        self.lanes = config.validate_lanes(lanes)
        self.max_frame = max_frame
        self.name = "ANSmsb" if h_approx == 1 else f"ANSsmsb-{h_approx}"

    def _enc_inputs(self, values):
        values = np.ascontiguousarray(values, dtype=np.uint32)
        _require_nonempty(values)
        mapped, k, b, hist = mj.msb_map_hist(jnp.asarray(values),
                                             length=MSB_MAX_SIGMA)
        freqs = np.asarray(hist).astype(np.uint64)
        max_sym = int(np.flatnonzero(freqs)[-1])
        nfreqs = adjust_freqs(freqs, max_sym, True, self.h_approx,
                              lane_frame_cap(self.max_frame))
        return mapped, k, b, nfreqs, nfreqs, b""

    def encode(self, values) -> bytes:
        return _encode_via_inputs(self, values)

    def _dec_table(self, buf: bytes):
        nfreqs, plen = load_prelude(buf)
        syms = np.arange(len(nfreqs), dtype=np.uint32)
        layout = _maybe_layout(nfreqs)
        dt = tables.build_dec_table(nfreqs,
                                    map_np.msb_unmap_high(syms),
                                    map_np.msb_exception_bytes(syms),
                                    layout=layout, slots=layout is None)
        return dt, plen

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        dt, off = self._dec_table(buf)
        return _decode_stream(buf, off, n, dt)


class AnsSmsb(AnsMsb):
    """reference: ans_smsb.hpp - AnsMsb with the H_approx knob exposed."""

    def __init__(self, h_approx: int, lanes: int | None = None):
        super().__init__(h_approx, lanes)


class AnsFold:
    """Generalized byte-fold rANS, fidelity 1..8 (reference:
    ans_fold.hpp:38-311), S-lane stream."""

    def __init__(self, fidelity: int, h_approx: int = 1,
                 lanes: int | None = None,
                 max_frame: int | None = DEFAULT_MAX_FRAME):
        assert 1 <= fidelity <= 8
        self.fidelity = fidelity
        self.h_approx = h_approx
        self.lanes = config.validate_lanes(lanes)
        self.max_frame = max_frame
        self.name = f"ANSfold-{fidelity}"

    def _enc_inputs(self, values):
        values = np.ascontiguousarray(values, dtype=np.uint32)
        _require_nonempty(values)
        mapped, k, b, hist = mj.fold_map_hist(
            jnp.asarray(values), fidelity=self.fidelity,
            length=fold_max_sigma(self.fidelity))
        freqs = np.asarray(hist).astype(np.uint64)
        max_sym = int(np.flatnonzero(freqs)[-1])
        nfreqs = adjust_freqs(freqs, max_sym, True, self.h_approx,
                              lane_frame_cap(self.max_frame))
        return mapped, k, b, nfreqs, nfreqs, b""

    def encode(self, values) -> bytes:
        return _encode_via_inputs(self, values)

    def _dec_table(self, buf: bytes):
        nfreqs, plen = load_prelude(buf)
        syms = np.arange(len(nfreqs), dtype=np.uint32)
        high, nb = map_np.fold_unmap_high(syms, self.fidelity)
        layout = _maybe_layout(nfreqs)
        dt = tables.build_dec_table(nfreqs, high, nb, layout=layout,
                                    slots=layout is None)
        return dt, plen

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        dt, off = self._dec_table(buf)
        return _decode_stream(buf, off, n, dt)


class AnsReorderFold:
    """Fold + most-frequent-symbol remap (reference:
    ans_reorder_fold.hpp:69-385), S-lane stream.  The u32 reorder flag and
    raw most_frequent[] table mirror the compat header."""

    def __init__(self, fidelity: int, h_approx: int = 1,
                 lanes: int | None = None,
                 max_frame: int | None = DEFAULT_MAX_FRAME):
        self.fidelity = fidelity
        self.h_approx = h_approx
        self.lanes = config.validate_lanes(lanes)
        self.max_frame = max_frame
        self.name = f"ANSrfold-{fidelity}"

    def _enc_inputs(self, values):
        values = np.ascontiguousarray(values, dtype=np.uint32)
        _require_nonempty(values)
        f = self.fidelity
        remapped_np, header = map_np.craft_reorder(values, f)
        mapped, k, b, hist = mj.fold_map_hist(
            jnp.asarray(remapped_np), fidelity=f,
            length=fold_max_sigma(f))
        freqs = np.asarray(hist).astype(np.uint64)
        max_sym = int(np.flatnonzero(freqs)[-1])
        nfreqs = adjust_freqs(freqs, max_sym, True, self.h_approx,
                              lane_frame_cap(self.max_frame))
        return mapped, k, b, nfreqs, nfreqs, bytes(header)

    def encode(self, values) -> bytes:
        return _encode_via_inputs(self, values)

    def _dec_table(self, buf: bytes):
        f = self.fidelity
        thres = fold_threshold(f)
        do_reorder = int.from_bytes(buf[0:4], "little")
        pos = 4
        if do_reorder == 1:
            mf = np.frombuffer(buf, dtype="<u4", count=thres, offset=pos)
            pos += 4 * thres
        else:
            mf = np.arange(thres, dtype=np.uint32)
        nfreqs, plen = load_prelude(buf[pos:])
        syms = np.arange(len(nfreqs), dtype=np.uint32)
        high, nb = map_np.fold_unmap_high(syms, f)
        if do_reorder == 1:
            high = np.where(syms < thres, mf[np.minimum(syms, thres - 1)],
                            high - np.uint32(thres)).astype(np.uint32)
        else:
            high = np.where(syms < thres, syms, high).astype(np.uint32)
        layout = _maybe_layout(nfreqs)
        dt = tables.build_dec_table(nfreqs, high, nb, layout=layout,
                                    slots=layout is None)
        return dt, pos + plen

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        dt, off = self._dec_table(buf)
        return _decode_stream(buf, off, n, dt)
