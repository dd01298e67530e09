"""Byte-level parity against blobs produced by the actual reference binary.

tests/fixtures/*.ref were generated once by compiling the (unmodified)
reference headers into a dump harness and compressing the committed .u32
inputs.  Two properties are checked:

1. our golden encoder reproduces every reference blob byte-for-byte,
   except the final word of each interp prelude, whose unused high bits
   the reference leaves uninitialized (bits.hpp bit_stream; we zero them);
2. our decoder round-trips reference-produced blobs exactly - i.e. a user
   switching frameworks can decode their existing compressed data.

Reference rfold-4 blobs for the zipf/mixed inputs are absent because the
reference fails its own round-trip there (the identity-mode defect noted in
docs/FORMAT.md), which the harness refused to dump.
"""

import json
import pathlib

import numpy as np
import pytest

from lane_ans.reference_model import model, parity, rans_compat as rc

FIX = pathlib.Path(__file__).parent / "fixtures"

CODECS = {
    "int": lambda: rc.AnsInt(),
    "msb": lambda: rc.AnsMsb(),
    "fold1": lambda: rc.AnsFold(1),
    "fold2": lambda: rc.AnsFold(2),
    "fold3": lambda: rc.AnsFold(3),
    "fold4": lambda: rc.AnsFold(4),
    "fold8": lambda: rc.AnsFold(8),
    "rfold1": lambda: rc.AnsReorderFold(1),
    "rfold2": lambda: rc.AnsReorderFold(2),
    "rfold4": lambda: rc.AnsReorderFold(4),
    "sint80": lambda: rc.AnsSint(80),
    "smsb80": lambda: rc.AnsSmsb(80),
}


def _cases():
    sizes = json.loads((FIX / "sizes.json").read_text())
    return sorted(sizes)


@pytest.mark.parametrize("case", _cases())
def test_parity(case):
    dname, method = case.split(".")
    data = np.fromfile(FIX / f"{dname}.u32", dtype="<u4")
    ref = (FIX / f"{dname}.{method}.ref").read_bytes()

    if method == "shuff":
        from lane_ans.reference_model.shuff_compat import ShuffCompat
        codec = ShuffCompat()
        mine = codec.encode(data)
        # the shuff bitstream is fully deterministic (no uninitialized
        # padding inside the wire): exact byte equality
        assert bytes(mine) == ref, f"{case}: shuff wire mismatch"
        np.testing.assert_array_equal(codec.decode(ref, len(data)), data)
        return

    if method == "byte":
        codec = rc.AnsByte()
        payload = (data & 0xFF).astype(np.uint8).tobytes()
        mine = codec.encode(payload)
        parity.assert_byte_blob_parity(bytes(mine), ref)
        assert codec.decode(ref, len(payload)) == payload
        return

    codec = CODECS[method]()
    mine = codec.encode(data)
    parity.assert_blob_parity(method, mine, ref)
    # cross-decode the reference's own bytes
    out = codec.decode(ref, len(data))
    np.testing.assert_array_equal(out, data)
