"""Block-data-parallel codec over a device mesh.

Scaling design (SURVEY.md section 2.6; no reference analogue — the
reference is single-threaded):

  * the input is split into D contiguous sections, one per mesh device;
  * one *shared* semi-static model is built from the global histogram
    (per-shard `jnp.bincount` + `lax.psum` over the mesh — on GPUs an
    NCCL all-reduce over NVLink, replacing a serial pass);
  * the rescaled frequency table is broadcast to every device
    (replicated sharding — XLA moves it once);
  * every device runs the S-lane stream coder on its section (so the
    mesh runs D*S independent ANS states): the XLA encode scan, and the
    decode engine models.engine.choose_engine picks (the fused decode
    kernel on GPUs, the XLA scan elsewhere), inside one shard_map
    program per stage;
  * compressed sections are gathered back in device order, giving
    deterministic, original-order reassembly.

The mesh is one flat axis: the cards of a host are joined all to all,
so device order is the only layout decision.

Methods: ANS / ANSmsb / ANSfold-f / ANSrfold-f / ANSsint-H / ANSsmsb-H
(the rfold value remap is a host pass over the global counts, exactly
one extra psum'd histogram; reference: ans_reorder_fold.hpp:69-385).

Wire format ("ATFB" container v2): see docs/FORMAT.md section 3.
"""

from __future__ import annotations

import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import (MSB_MAX_SIGMA, fold_max_sigma, fold_threshold)
from ..models import config, engine as _engine, framing
from ..ops import lane_codec, lane_kernel, mappings_jax as mj, tables
from ..reference_model import mappings as map_np
from ..reference_model.model import (adjust_freqs, load_prelude,
                                     serialize_prelude)

MAGIC = 0x41544642  # "BFTA" little-endian -> "ATFB"

KINDS = {"int": 0, "msb": 1, "fold": 2, "rfold": 3}
_KIND_NAMES = {v: k for k, v in KINDS.items()}


def make_mesh(n_devices: int | None = None, axis: str = "blocks") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def describe_container(blob: bytes):
    """(method, n, D) from an ATFB header — the inverse of
    _parse_method over the stored kind/fidelity/h_approx fields, so a
    caller (the file CLI) can build the matching BlockCodec without
    out-of-band knowledge."""
    magic, _ver, kind_id, fid, h_app, n, D = struct.unpack_from(
        "<IBBBBII", blob, 0)
    if magic != MAGIC:
        raise ValueError("not an ATFB container")
    kind = _KIND_NAMES[kind_id]
    if kind == "int":
        method = "ANS" if h_app == 1 else f"ANSsint-{h_app}"
    elif kind == "msb":
        method = "ANSmsb" if h_app == 1 else f"ANSsmsb-{h_app}"
    else:
        method = f"ANS{kind}-{fid}"
    return method, int(n), int(D)


def _parse_method(method: str):
    """-> (kind, fidelity, h_approx)."""
    if method == "ANS":
        return "int", 0, 1
    if method == "ANSmsb":
        return "msb", 0, 1
    for prefix, kind in (("ANSfold-", "fold"), ("ANSrfold-", "rfold"),
                         ("ANSsint-", "int"), ("ANSsmsb-", "msb")):
        if method.startswith(prefix):
            v = int(method[len(prefix):])
            if kind in ("fold", "rfold"):
                return kind, v, 1
            return kind, 0, v
    raise ValueError(f"blocked runtime supports ANS/ANSmsb/ANSfold-f/"
                     f"ANSrfold-f/ANSsint-H/ANSsmsb-H, not {method!r}")


class BlockCodec:
    """Shared-model, block-parallel encode/decode over a mesh."""

    def __init__(self, method: str = "ANSfold-2", mesh: Mesh | None = None,
                 lanes: int | None = None, h_approx: int | None = None):
        self.kind, self.fidelity, h_m = _parse_method(method)
        self.h_approx = h_approx if h_approx is not None else h_m
        self.method = method
        self.mesh = mesh or make_mesh()
        self.lanes = config.validate_lanes(lanes)
        self.axis = self.mesh.axis_names[0]
        self._programs = {}  # (stage, *static_params) -> jitted program

    def _cached(self, key, build):
        if key not in self._programs:
            self._programs[key] = build()
        return self._programs[key]

    # -- shared-model front end (device psum histogram) --------------------

    @functools.cached_property
    def _sigma_cap(self):
        if self.kind == "msb":
            return MSB_MAX_SIGMA
        if self.kind in ("fold", "rfold"):
            return fold_max_sigma(self.fidelity)
        return None

    def _padding_symbol(self) -> int:
        """Mapped id the zero padding contributes to the histogram
        (vals are padded to D*B with zeros before the device pass)."""
        if self.kind == "msb":
            return int(map_np.msb_map(np.zeros(1, np.uint32))[0])
        if self.kind in ("fold", "rfold"):
            return int(map_np.fold_map(np.zeros(1, np.uint32),
                                       self.fidelity)[0])
        return 0

    def _map_hist_program(self, sigma_cap: int):
        """(D, B) u32 -> mapped/k/b sharded + replicated global histogram."""
        kind = "fold" if self.kind == "rfold" else self.kind
        fid, axis = self.fidelity, self.axis

        def body(vals):
            v = vals[0]
            if kind == "msb":
                mapped = mj.msb_map(v)
                k = mj.msb_exception_bytes(mapped)
            elif kind == "fold":
                mapped = mj.fold_map(v, fid)
                k = mj.fold_exception_count(v, fid)
            else:
                mapped, k = v, jnp.zeros_like(v)
            b = mj.low_bytes(v)
            hist = jax.lax.psum(jnp.bincount(mapped, length=sigma_cap),
                                axis)
            return mapped[None], k[None], b[None], hist

        return self._cached(("map_hist", sigma_cap), lambda: jax.jit(
            self._shard_map(body, (P(self.axis),),
                            (P(self.axis), P(self.axis), P(self.axis),
                             P()))))

    def _shard_map(self, body, in_specs, out_specs):
        # the replication checker is off: the lane scans' carries start
        # from replicated constants and become device-varying in the
        # loop, which the checker rejects for a plain data-parallel map
        return jax.shard_map(body, mesh=self.mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    # -- per-device bodies ---------------------------------------------------

    def _encode_program(self, S, T, log2m):
        axis = self.axis

        def body(mapped, k, b, n_sec, freq, base, ub):
            stream, total, states, step_base = lane_codec.encode_lanes_impl(
                mapped[0], k[0], b[0], n_sec[0], freq, base, ub,
                S=S, T=T, log2m=log2m)
            return stream[None], total[None], states[None], step_base[None]

        return self._cached(("enc", S, T, log2m), lambda: jax.jit(
            self._shard_map(body, (P(axis), P(axis), P(axis), P(axis),
                                   P(), P(), P()),
                            (P(axis), P(axis), P(axis), P(axis)))))

    def _decode_program(self, S, T, log2m, has_exc, engine):
        axis = self.axis
        kw = dict(S=S, T=T, log2m=log2m, has_exc=has_exc)

        def body(stream, states, n_sec, dfreq, doff, dsym, dhigh, dnb):
            if engine == "kernel":
                out = lane_kernel.decode(
                    stream[0], states[0], dfreq, doff,
                    dhigh if has_exc else dsym, dnb, n_sec[0], **kw)
            else:
                out = lane_codec.decode_lanes_impl(
                    stream[0], states[0], dfreq, doff, dsym, dhigh, dnb,
                    n_sec[0], **kw)
            return out[None]

        return self._cached(("dec", S, T, log2m, has_exc, engine),
                            lambda: jax.jit(self._shard_map(
                                body, (P(axis), P(axis), P(axis),
                                       P(), P(), P(), P(), P()),
                                P(axis))))

    # -- host orchestration ------------------------------------------------

    def _reorder_remap(self, values: np.ndarray):
        """rfold host pass (shared craft_reorder; see
        reference_model/mappings.py).  Returns (remapped values,
        header bytes)."""
        from ..reference_model.mappings import craft_reorder
        return craft_reorder(values, self.fidelity)

    def encode(self, values, hist_override=None, premapped=None,
               reorder_header=None) -> bytes:
        """hist_override: a precomputed GLOBAL symbol histogram (the
        multi-host runtime passes the cross-process allreduce so every
        shard derives the same model; parallel/multihost.py).
        premapped: the (mapped, k, b) device arrays from a prior
        _map_hist_program run over the same values at the same
        sigma_cap, so multi-host encode doesn't pay the map pass twice.
        reorder_header: for rfold, the wire header bytes of an ALREADY
        APPLIED global reorder (multi-host derives the permutation from
        the allreduced raw histogram and remaps each shard before
        calling encode; the local remap here would disagree between
        shards)."""
        values = np.ascontiguousarray(values, dtype=np.uint32)
        n = len(values)
        if n == 0:
            raise ValueError("cannot encode an empty sequence")
        header_extra = b""
        if self.kind == "rfold":
            if reorder_header is not None:
                header_extra = reorder_header
            else:
                values, header_extra = self._reorder_remap(values)
        D = self.mesh.devices.size
        B = -(-n // D)
        vals = np.zeros(D * B, dtype=np.uint32)
        vals[:n] = values
        vals = vals.reshape(D, B)
        n_sec = np.clip(n - B * np.arange(D), 0, B).astype(np.int32)

        sigma_cap = self._sigma_cap or (int(values.max()) + 1)
        if hist_override is not None:
            sigma_cap = max(sigma_cap, len(hist_override))
        if premapped is not None:
            mapped, k, b = premapped
            hist = None
        else:
            mapped, k, b, hist = self._map_hist_program(sigma_cap)(vals)
        freqs = (np.asarray(hist) if hist_override is None
                 else np.asarray(hist_override)).astype(np.uint64)
        if hist_override is None and D * B > n:
            # the device pass histograms the zero padding too; remove
            # it so the model reflects the data (multihost subtracts
            # its own shard padding before the allreduce)
            freqs = freqs.copy()
            freqs[self._padding_symbol()] -= D * B - n
        max_sym = int(np.flatnonzero(freqs)[-1])
        from ..models.ans import lane_frame_cap
        nfreqs = adjust_freqs(freqs, max_sym, self.kind != "int",
                              self.h_approx, lane_frame_cap(None))
        prelude = serialize_prelude(nfreqs, int(nfreqs.sum()))
        # identity kind over a huge live alphabet: tail-escape recoding
        # (ops/escape.py) — the frame folds, the prelude stays true,
        # decode re-derives the same plan from the prelude
        plan = None
        if self.kind == "int":
            from ..ops import escape as escape_mod
            plan = escape_mod.plan_from_freqs(nfreqs)
        if plan is not None:
            m_np, k_np, b_np = plan.map_values(vals)
            mapped = jnp.asarray(m_np)
            k = jnp.asarray(k_np)
            b = jnp.asarray(b_np)
            frame_freqs = plan.frame_freqs
        else:
            frame_freqs = nfreqs
        from ..ops import grouped as grouped_mod
        layout = (grouped_mod.build_group_layout(frame_freqs)
                  if grouped_mod.use_grouped_layout(frame_freqs)
                  else None)
        et = tables.build_enc_table(frame_freqs, layout)

        S = self.lanes or config.default_lane_count(B)
        T = lane_codec.lane_steps(B, S)

        out = bytearray()
        out += struct.pack("<IBBBBII", MAGIC, 2, KINDS[self.kind],
                           self.fidelity, self.h_approx, n, D)
        out += header_extra
        out += struct.pack("<I", len(prelude)) + prelude

        pad = T * S - B
        mapped_ts = jnp.pad(mapped, ((0, 0), (0, pad))).reshape(D, T, S)
        k_ts = jnp.pad(k, ((0, 0), (0, pad))).reshape(D, T, S)
        b_ts = jnp.pad(b, ((0, 0), (0, pad), (0, 0))).reshape(D, T, S, 3)
        stream, totals, states, step_base = self._encode_program(
            S, T, et.log2m)(
            mapped_ts, k_ts, b_ts, jnp.asarray(n_sec),
            jnp.asarray(et.freq), jnp.asarray(et.base), jnp.asarray(et.ub))
        totals = np.asarray(totals)
        states = np.asarray(states)
        step_base = np.asarray(step_base)
        for d in range(D):
            sec = framing.pack_encoded(stream[d], totals[d], states[d],
                                       step_base[d], T)
            out += struct.pack("<I", len(sec)) + sec
        return bytes(out)

    def decode(self, blob: bytes, n: int | None = None) -> np.ndarray:
        magic, ver, kind_id, fid, h_app, n_stored, D = struct.unpack_from(
            "<IBBBBII", blob, 0)
        if magic != MAGIC:
            raise ValueError("not an ATFB container")
        kind = _KIND_NAMES[kind_id]
        if kind != self.kind or fid != self.fidelity:
            raise ValueError(
                f"container method {kind}/{fid} does not match codec "
                f"{self.kind}/{self.fidelity}")
        if n is not None and n != n_stored:
            # the stream is cut into D per-device sections of
            # ceil(n_stored/D); a different n re-derives a different
            # split and silently interleaves wrong ranges
            raise ValueError(
                f"ATFB containers are not prefix-decodable: n={n} != "
                f"stored n={n_stored}")
        n = n_stored
        pos = 16
        mf = None
        if kind == "rfold":
            (do_reorder,) = struct.unpack_from("<I", blob, pos)
            pos += 4
            thres = fold_threshold(fid)
            if do_reorder == 1:
                mf = np.frombuffer(blob, dtype="<u4", count=thres,
                                   offset=pos)
                pos += 4 * thres
        (plen,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        nfreqs, _ = load_prelude(blob[pos:pos + plen + 8])
        pos += plen

        syms = np.arange(len(nfreqs), dtype=np.uint32)
        if kind == "int":
            # tail-escape / grouped / plain, derived from the prelude
            # exactly like the unblocked codec
            from ..models.ans import _int_dec_table
            dt = _int_dec_table(nfreqs)
        else:
            from ..ops import grouped as grouped_mod
            layout = (grouped_mod.build_group_layout(nfreqs)
                      if grouped_mod.use_grouped_layout(nfreqs) else None)
            if kind == "msb":
                high = map_np.msb_unmap_high(syms)
                nb = map_np.msb_exception_bytes(syms)
            else:  # fold / rfold
                high, nb = map_np.fold_unmap_high(syms, fid)
                if kind == "rfold":
                    thres = fold_threshold(fid)
                    if mf is not None:
                        high = np.where(
                            syms < thres, mf[np.minimum(syms, thres - 1)],
                            high - np.uint32(thres)).astype(np.uint32)
                    else:
                        high = np.where(syms < thres, syms,
                                        high).astype(np.uint32)
            dt = tables.build_dec_table(nfreqs, high, nb, layout=layout,
                                        slots=layout is None)
        has_exc = dt.has_exc

        B = -(-n // D)
        n_sec = np.clip(n - B * np.arange(D), 0, B).astype(np.int32)
        secs = []
        for _ in range(D):
            (slen,) = struct.unpack_from("<I", blob, pos)
            pos += 4
            secs.append(framing.parse(blob[pos:pos + slen], 0))
            pos += slen
        S = secs[0][0]
        T = lane_codec.lane_steps(B, S)

        maxp = max(len(s[2]) for s in secs) + 8
        stream = np.zeros((D, maxp), dtype=np.uint8)
        states = np.zeros((D, S), dtype=np.uint32)
        for d, (_, st, pay, _t_sec, _sec_len) in enumerate(secs):
            stream[d, :len(pay)] = pay
            states[d] = st
        dt = tables.materialize_slots(dt)  # both engines read slot arrays
        dummy = np.zeros(1, np.uint32)
        out = self._decode_program(S, T, dt.log2m, has_exc,
                                   _engine.choose_engine(S))(
            jnp.asarray(stream),
            jnp.asarray(states), jnp.asarray(n_sec),
            jnp.asarray(dt.freq), jnp.asarray(dt.offset),
            jnp.asarray(dt.sym),
            jnp.asarray(dt.high if has_exc else dummy),
            jnp.asarray(dt.nb if has_exc else dummy))
        out = np.asarray(out)  # (D, T, S)
        parts = [out[d].reshape(-1)[:n_sec[d]] for d in range(D)]
        return np.concatenate(parts).astype(np.uint32)[:n]


def encode_blocked(values, method="ANSfold-2", mesh=None, lanes=None):
    return BlockCodec(method, mesh, lanes).encode(values)


def decode_blocked(blob, n=None, method="ANSfold-2", mesh=None, lanes=None):
    return BlockCodec(method, mesh, lanes).decode(blob, n)
