"""Byte-level codecs: vbyte, streamvbyte, the ans_byte entropy coder, and
the byte-split+entropy composites.

Counterparts of reference include/methods.hpp:38-102 (vbyte/streamvbyte
via external libs), include/ans_byte.hpp (the in-repo byte rANS), and the
composite adapters methods.hpp:432-482 (vbyteANS / streamvbyteANS) and
:159-250 (fse / vbytefse — backed by the framework's real tANS,
models/tans.py, since the reference's FSE is an external unvendored
library; formats are self-defined).  Split kernels run on device
(ops/bytesplit.py, XLA scatters and gathers); the ANS byte entropy
stage is the S-lane engine over the 256-symbol alphabet.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops import bytesplit, tables
from . import config
from .ans import _decode_stream, _encode_stream, _require_nonempty


class Vbyte:
    """7-bit varint splitter (methods.hpp:38-59), on device
    (ops/bytesplit)."""

    name = "vbyte"

    def encode(self, values) -> bytes:
        values = np.ascontiguousarray(values, dtype=np.uint32)
        _require_nonempty(values)
        out, total = bytesplit.vbyte_encode(jnp.asarray(values))
        return np.asarray(out[: int(total)]).tobytes()

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        arr = np.frombuffer(buf, dtype=np.uint8)
        arr = np.concatenate([arr, np.zeros(8, np.uint8)])
        return np.asarray(bytesplit.vbyte_decode(jnp.asarray(arr), n=n))


class StreamVbyte:
    """2-bit-key byte splitter (methods.hpp:89-102), on device
    (ops/bytesplit)."""

    name = "streamvbyte"

    def encode(self, values) -> bytes:
        values = np.ascontiguousarray(values, dtype=np.uint32)
        _require_nonempty(values)
        control, data, total = bytesplit.svb_encode(jnp.asarray(values))
        return (np.asarray(control).tobytes()
                + np.asarray(data[: int(total)]).tobytes())

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        nc = -(-n // 4)
        control = np.frombuffer(buf, dtype=np.uint8, count=nc)
        data = np.frombuffer(buf, dtype=np.uint8, offset=nc)
        data = np.concatenate([data, np.zeros(8, np.uint8)])
        return np.asarray(bytesplit.svb_decode(
            jnp.asarray(control), jnp.asarray(data), n=n))


class AnsByte:
    """S-lane rANS over the byte alphabet (reference: ans_byte.hpp:99-300).

    Same model as compat (byte_adjust_freqs, raw 256-entry interp prelude
    over universe 4096+256) but the stream is lane-format.  Operates on
    byte strings: encode(bytes) -> bytes, decode(buf, n) -> bytes.
    """

    name = "ansbyte"

    def __init__(self, lanes: int | None = None):
        self.lanes = config.validate_lanes(lanes)

    def encode(self, data: bytes) -> bytes:
        arr = np.frombuffer(data, dtype=np.uint8)
        if len(arr) == 0:
            raise ValueError("cannot encode an empty sequence")
        import time as _time

        from .. import native
        from ..reference_model.rans_compat import byte_prelude_encode
        from ..utils.stats import record_stats
        t0 = _time.perf_counter_ns()
        freqs = native.byte_histogram(arr)
        prelude, nfreqs = byte_prelude_encode(freqs)
        t1 = _time.perf_counter_ns()
        stream = _encode_stream(jnp.asarray(arr.astype(np.uint32)), None,
                                None, len(arr), nfreqs, self.lanes)
        record_stats(prelude_bytes=len(prelude), encode_bytes=len(stream),
                     prelude_time_ns=t1 - t0,
                     encode_time_ns=_time.perf_counter_ns() - t1)
        return prelude + stream

    def decode(self, buf: bytes, n: int) -> bytes:
        from ..reference_model.rans_compat import byte_prelude_decode
        nfreqs, off = byte_prelude_decode(buf)
        dt = tables.build_dec_table(nfreqs.astype(np.uint32))
        out = _decode_stream(buf, off, n, dt)
        return out.astype(np.uint8).tobytes()


class _SplitPlusByteEntropy:
    """Generic byte-split + byte-entropy composite
    (methods.hpp:432-482 vbyteANS/streamvbyteANS shape: u32 byte-count
    header, then the entropy-coded split bytes)."""

    def __init__(self, split, entropy, name):
        self.split = split
        self.entropy = entropy
        self.name = name

    def encode(self, values) -> bytes:
        split_bytes = self.split.encode(values)
        return (len(split_bytes).to_bytes(4, "little")
                + self.entropy.encode(split_bytes))

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        nb = int.from_bytes(buf[0:4], "little")
        split_bytes = self.entropy.decode(buf[4:], nb)
        return self.split.decode(split_bytes, n)


def VbyteAns(lanes=None):
    return _SplitPlusByteEntropy(Vbyte(), AnsByte(lanes), "vbyteANS")


def StreamVbyteAns(lanes=None):
    return _SplitPlusByteEntropy(StreamVbyte(), AnsByte(lanes),
                                 "streamvbyteANS")


def FseEquivalent(lanes=None):
    """The reference's `fse` method (methods.hpp:159-176) over the
    framework's real tANS (models/tans.py)."""
    from .tans import Fse
    return Fse()


def VbyteFse(lanes=None):
    from .tans import ByteTans
    return _SplitPlusByteEntropy(Vbyte(), ByteTans(), "vbytefse")


def StreamVbyteFse(lanes=None):
    from .tans import ByteTans
    return _SplitPlusByteEntropy(StreamVbyte(), ByteTans(),
                                 "streamvbytefse")


class ByteShuff:
    """Blockwise canonical-Huffman byte entropy coder — the huff0
    equivalent (reference: methods.hpp:104-157 wraps FSE's HUF_compress
    in 128 KiB blocks with u32 framing and a stored-block fallback; here
    the entropy stage is models.shuff over the byte alphabet).

    Block framing: u32 comp_len | blob;  comp_len == 0xFFFFFFFF marks a
    stored (incompressible) block.
    """

    name = "huff0"
    BLOCK = 128 * 1024

    def encode(self, data: bytes) -> bytes:
        from .shuff import Shuff
        if len(data) == 0:
            raise ValueError("cannot encode an empty sequence")
        out = bytearray()
        sh = Shuff()
        for i in range(0, len(data), self.BLOCK):
            blk = data[i:i + self.BLOCK]
            arr = np.frombuffer(blk, dtype=np.uint8).astype(np.uint32)
            blob = sh.encode(arr)
            if len(blob) >= len(blk):
                out += (0xFFFFFFFF).to_bytes(4, "little") + blk
            else:
                out += len(blob).to_bytes(4, "little") + blob
        return bytes(out)

    def decode(self, buf: bytes, n: int) -> bytes:
        from .shuff import Shuff
        out = bytearray()
        pos = 0
        sh = Shuff()
        while len(out) < n:
            blen = min(self.BLOCK, n - len(out))
            clen = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
            if clen == 0xFFFFFFFF:
                out += buf[pos:pos + blen]
                pos += blen
            else:
                vals = sh.decode(buf[pos:pos + clen + 8], blen)
                out += vals.astype(np.uint8).tobytes()
                pos += clen
        return bytes(out)


class HuffZero:
    """huff0 the way the reference registers it: blockwise byte-Huffman
    over the raw little-endian bytes of the u32 input."""

    name = "huff0"

    def __init__(self):
        self.entropy = ByteShuff()

    def encode(self, values) -> bytes:
        values = np.ascontiguousarray(values, dtype="<u4")
        _require_nonempty(values)
        return self.entropy.encode(values.tobytes())

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        raw = self.entropy.decode(buf, n * 4)
        return np.frombuffer(raw, dtype="<u4").copy()


def VbyteHuffzero():
    return _SplitPlusByteEntropy(Vbyte(), ByteShuff(), "vbytehuffzero")


def StreamVbyteHuffzero():
    return _SplitPlusByteEntropy(StreamVbyte(), ByteShuff(),
                                 "streamvbytehuffzero")


class EntropyOnly:
    """Lower-bound pseudo-codec: encode returns ceil(H0*n/8) placeholder
    bytes; decode is an error (methods.hpp:622-637)."""

    name = "entropy"

    def encode(self, values) -> bytes:
        from ..utils import metrics
        values = np.asarray(values)
        h0 = metrics.compute_entropy(values)
        return bytes(int(np.ceil(h0 * len(values) / 8.0)))

    def decode(self, buf: bytes, n: int):
        raise RuntimeError("entropy_only is a size bound, not a codec "
                           "(reference: methods.hpp:632-636)")
