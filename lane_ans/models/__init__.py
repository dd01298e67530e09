"""Codec registry — the counterpart of the reference's uniform methods
interface (reference: include/methods.hpp:41-637).

Every codec exposes `encode(values) -> bytes` and
`decode(buf, n) -> np.uint32 array` (decode is size-directed, like the
reference).  Two engines per ANS method:

  * "lane"   - S-lane device wire format (ops.lane_codec, default)
  * "compat" - bit-exact reference wire format (reference_model.rans_compat)
"""

from __future__ import annotations

from ..reference_model import rans_compat as _rc
from . import ans as _lane


def _host_methods():
    """Engine-independent codecs (baselines + byte splitters); lazy
    imports keep `import lane_ans.models` light."""
    from . import bytes as _b
    from .arith import Arith
    from .pfor import OptPFor
    from .pseudo_adaptive import PseudoAdaptive as _pa
    from .shuff import Shuff
    return {
        "vbyte": _b.Vbyte,
        "streamvbyte": _b.StreamVbyte,
        "optpfor": OptPFor,
        "OptPFor": OptPFor,
        "shuff": Shuff,
        "arith": Arith,
        "fse": _b.FseEquivalent,
        "huffzero": _b.HuffZero,
        "huff0": _b.HuffZero,
        "vbytefse": _b.VbyteFse,
        "streamvbytefse": _b.StreamVbyteFse,
        "vbytehuffzero": _b.VbyteHuffzero,
        "streamvbytehuffzero": _b.StreamVbyteHuffzero,
        "vbyteANS": _b.VbyteAns,
        "streamvbyteANS": _b.StreamVbyteAns,
        "entropy_only": _b.EntropyOnly,
        "entropy": _b.EntropyOnly,
        "pseudo_adaptive": _pa,
    }


_LANE = {
    "ANS": lambda: _lane.AnsInt(),
    "ANSmsb": lambda: _lane.AnsMsb(),
    **{f"ANSfold-{f}": (lambda f=f: _lane.AnsFold(f)) for f in range(1, 9)},
    **{f"ANSrfold-{f}": (lambda f=f: _lane.AnsReorderFold(f))
       for f in range(1, 9)},
    **{f"ANSsint-{h}": (lambda h=h: _lane.AnsSint(h))
       for h in (1, 5, 10, 20, 40, 80, 160, 320)},
    **{f"ANSsmsb-{h}": (lambda h=h: _lane.AnsSmsb(h))
       for h in (1, 5, 10, 20, 40, 80, 160, 320)},
}

_COMPAT = {
    "ANS": lambda: _rc.AnsInt(),
    "ANSmsb": lambda: _rc.AnsMsb(),
    **{f"ANSfold-{f}": (lambda f=f: _rc.AnsFold(f)) for f in range(1, 9)},
    **{f"ANSrfold-{f}": (lambda f=f: _rc.AnsReorderFold(f))
       for f in range(1, 9)},
    **{f"ANSsint-{h}": (lambda h=h: _rc.AnsSint(h))
       for h in (1, 5, 10, 20, 40, 80, 160, 320)},
    **{f"ANSsmsb-{h}": (lambda h=h: _rc.AnsSmsb(h))
       for h in (1, 5, 10, 20, 40, 80, 160, 320)},
}


def available(engine: str = "lane"):
    reg = dict(_LANE if engine == "lane" else _COMPAT)
    reg.update(_host_methods())
    return sorted(reg)


def get(name: str, engine: str = "lane"):
    reg = dict({"lane": _LANE, "compat": _COMPAT}[engine])
    reg.update(_host_methods())
    if engine == "compat" and name == "shuff":
        # the compat engine is the reference-wire surface; shuff has a
        # bit-exact reimplementation of the reference's canonical
        # Huffman wire (reference_model/shuff_compat.py), while the
        # lane engine keeps the fast LUT codec (models/shuff.py)
        from ..reference_model.shuff_compat import ShuffCompat
        return ShuffCompat()
    if name not in reg:
        raise KeyError(f"unknown method {name!r}; known: {sorted(reg)}")
    return reg[name]()


def prepare_decoder(name: str, blob: bytes, n: int, *,
                    engine: str | None = None, interpret: bool = False):
    """Stage a lane-format blob for repeated device decodes: parses the
    wire prelude, rebuilds the decode table the same way `decode()`
    does, and returns a models.engine.PreparedDecoder (the production
    serving pattern — tables + stream live in device memory, each call
    runs only the decode engine).  engine/interpret are test knobs
    ("kernel" | "xla", kernel in the Pallas interpreter); production
    callers pass neither."""
    if name not in _LANE:
        raise KeyError(f"{name!r} is not a lane-format ANS method")
    from ..ops import lane_codec
    from . import framing
    from .engine import PreparedDecoder
    codec = _LANE[name]()
    # NB: the builtin `bytes` is shadowed here by the models.bytes
    # submodule (package __init__ namespace), hence memoryview
    blob = memoryview(blob).tobytes()
    dt, off = codec._dec_table(blob)
    S, states, payload, _, _ = framing.parse(blob, off)
    T = lane_codec.lane_steps(n, S)
    return PreparedDecoder(payload, states, dt, n, S=S, T=T,
                           has_exc=dt.has_exc, engine=engine,
                           interpret=interpret)


def prepare_encoder(name: str, values, *, lanes: int = 4096):
    """Stage device-resident encode for repeated runs: model build +
    mapping (the codec's _enc_inputs half), tables and (T,S) lane
    staging, returning a models.engine.PreparedEncoder.  Each call then
    runs only the lane encode scan + placement (the serving pattern).
    `pe.prelude + pe.to_bytes(*pe())` is the full wire container —
    byte-identical to `codec.encode(values)` for a codec built with the
    same lane count (the registry defaults are used for everything
    else: h_approx=1, honest frame)."""
    if name not in _LANE:
        raise KeyError(f"{name!r} is not a lane-format ANS method")
    from ..ops import lane_codec, tables
    from ..reference_model.model import serialize_prelude
    from . import config
    from .ans import _maybe_layout, _stage_ts
    from .engine import PreparedEncoder
    codec = _LANE[name]()
    mapped, k, b, pfreqs, ffreqs, header = codec._enc_inputs(values)
    n = int(mapped.shape[0])
    S = config.validate_lanes(lanes) or config.default_lane_count(n)
    T = lane_codec.lane_steps(n, S)
    et = tables.build_enc_table(ffreqs, _maybe_layout(ffreqs))
    mapped_ts, nb_ts, excb_ts = _stage_ts(mapped, k, b, n, S, T)
    pe = PreparedEncoder(mapped_ts, nb_ts, excb_ts, n, et, S=S, T=T)
    pe.prelude = header + serialize_prelude(pfreqs, int(pfreqs.sum()))
    return pe
