"""Randomized differential parity fuzz vs the REAL reference binary.

The fixture suite (tests/test_reference_parity.py) proves byte-parity on
14 committed blobs; this tool proves it on unbounded seeded random
cases, with the unmodified reference coders compiled into
tools/ref_dump.cpp as the oracle.  Per case it checks four directions:

  1. ref_encode(data) round-trips through ref_decode (oracle sanity —
     the reference has known self-round-trip defects, see below);
  2. our compat encode is byte-identical to the reference blob outside
     the interp-padding word (reference_model.parity);
  3. our compat decode returns the original data from the REFERENCE's
     blob (a reference user can switch frameworks in place);
  4. the reference decodes OUR blob back to the original data (and can
     switch back).

Known reference defects are auto-detected at step 1 and downgraded to a
self-check of our own codec (both engines round-trip): rfold identity
mode with values >= the fold threshold mis-decodes
(ans_reorder_fold.hpp:288-302), and fold/msb values >= 2^30 overflow the
exception path (docs/FORMAT.md) — we fix both, so byte-parity is
impossible there by design.  Single-symbol inputs hang the reference
outright (adjust_freqs never converges), so every generated case has
sigma >= 2; ref_dump always runs under a hard timeout as a backstop.

Usage: python tools/fuzz_parity.py [--cases 80] [--seed 0]
       [--methods int,msb,...] [--keep-going]
Exit 0 = every case passed (or was a detected reference defect).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from lane_ans.reference_model import parity, rans_compat as rc

REF_INCLUDE = "/root/reference/include"
BIN = os.environ.get("ANS_REF_DUMP",
                     os.path.join(tempfile.gettempdir(), "ref_dump"))
TIMEOUT = 30  # seconds per ref_dump invocation (hang backstop; real
# cases at these sizes take well under a second)


def build_ref_dump() -> str:
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "ref_dump.cpp")
    if (os.path.exists(BIN)
            and os.path.getmtime(BIN) >= os.path.getmtime(src)):
        return BIN
    subprocess.run(["g++", "-O2", "-std=c++17", f"-I{REF_INCLUDE}",
                    src, "-o", BIN], check=True)
    return BIN


def our_codec(method: str):
    if method == "byte":
        return rc.AnsByte()
    if method == "shuff":
        from lane_ans.reference_model.shuff_compat import ShuffCompat
        return ShuffCompat()
    if method == "int":
        return rc.AnsInt()
    if method == "msb":
        return rc.AnsMsb()
    if method.startswith("fold"):
        return rc.AnsFold(int(method[4:]))
    if method.startswith("rfold"):
        return rc.AnsReorderFold(int(method[5:]))
    if method.startswith("sint"):
        return rc.AnsSint(int(method[4:]))
    if method.startswith("smsb"):
        return rc.AnsSmsb(int(method[4:]))
    raise ValueError(method)


def gen_case(rng: np.random.Generator, method: str):
    """One random (name, data) pair; sigma >= 2 always (the reference
    hangs on single-symbol alphabets).  int/sint code the raw value
    domain with value-indexed tables on both sides, so their values are
    capped at 2^22 (a 2^31 max would mean multi-GB histograms in BOTH
    frameworks — not a defect, just out of the methods' design range).
    The 'huge' family (values to 2^31) exercises the reference's >= 2^30
    fold/msb exception defect via the defect-detection path."""
    n = int(rng.choice([37, 997, 5000, 20000, 100000]))
    kinds = ["zipf", "uniform", "geometric", "head_tail",
             "clustered", "binary", "huge"]
    direct_domain = method.startswith(("int", "sint", "shuff"))
    if direct_domain:
        kinds.remove("huge")
    kind = rng.choice(kinds)
    if kind == "zipf":
        u = int(rng.choice([1 << 8, 1 << 12, 1 << 16, 1 << 20]))
        s = float(rng.choice([1.1, 1.3, 1.8]))
        data = np.minimum(rng.zipf(s, size=n) - 1, u - 1)
    elif kind == "uniform":
        u = int(rng.choice([4, 1 << 8, 1 << 14, 1 << 20]))
        data = rng.integers(0, u, size=n)
    elif kind == "geometric":
        p = float(rng.choice([0.02, 0.4, 0.9]))
        data = rng.geometric(p, size=n) - 1
    elif kind == "head_tail":
        data = rng.integers(0, 4, size=n)
        k = max(2, n // 50)
        data[rng.choice(n, size=k, replace=False)] = rng.integers(
            1 << 10, 1 << 24, size=k)
    elif kind == "clustered":
        centers = rng.integers(0, 1 << 16, size=8)
        data = (centers[rng.integers(0, 8, size=n)]
                + rng.integers(0, 16, size=n))
    elif kind == "binary":
        data = (rng.random(size=n) < 0.03).astype(np.uint32) * int(
            rng.integers(1, 1 << 20))
    else:  # huge: values straddling the reference's 2^30 defect line
        data = rng.integers(0, 1 << 31, size=n)
    data = data.astype(np.uint32)
    if direct_domain:
        data = np.minimum(data, (1 << 22) - 1)
    if len(np.unique(data[:256])) < 2 and len(np.unique(data)) < 2:
        data[0] ^= 1  # sigma >= 2
    return f"{kind}/n={n}", data


def ref_encode(method, data, tmp):
    inp = os.path.join(tmp, "in.u32")
    out = os.path.join(tmp, "ref.blob")
    data.astype("<u4").tofile(inp)
    r = subprocess.run([BIN, "encode", method, inp, out],
                       capture_output=True, timeout=TIMEOUT)
    if r.returncode != 0:
        raise RuntimeError(f"ref encode rc={r.returncode}: "
                           f"{r.stderr.decode()[:200]}")
    return open(out, "rb").read()


def ref_decode(method, blob, n, tmp):
    inp = os.path.join(tmp, "in.blob")
    out = os.path.join(tmp, "out.u32")
    open(inp, "wb").write(blob)
    r = subprocess.run([BIN, "decode", method, inp, str(n), out],
                       capture_output=True, timeout=TIMEOUT)
    if r.returncode != 0:
        raise RuntimeError(f"ref decode rc={r.returncode}: "
                           f"{r.stderr.decode()[:200]}")
    return np.fromfile(out, dtype="<u4")


def run_case(method, name, data, tmp):
    """Returns 'ok' | 'ref-defect' (our codec self-checked) | raises."""
    if method == "byte":
        return _run_byte_case(name, data, tmp)
    n = len(data)
    try:
        blob_ref = ref_encode(method, data, tmp)
        ref_rt = ref_decode(method, blob_ref, n, tmp)
        ref_self_ok = bool((ref_rt == data).all())
    except (RuntimeError, subprocess.TimeoutExpired):
        ref_self_ok = False
    codec = our_codec(method)
    if not ref_self_ok:
        # reference defect: our framework must still round-trip
        mine = codec.encode(data)
        np.testing.assert_array_equal(codec.decode(mine, n), data,
                                      err_msg=f"{method} {name} (ours)")
        return "ref-defect"
    mine = codec.encode(data)
    if method == "shuff":
        # fully deterministic bitstream, but the oracle dumps the
        # reference's truncated size + one slack word (ref_dump.cpp):
        # ours must be an exact prefix with <= 8 trailing slack bytes
        assert (len(blob_ref) - len(mine) in (0, 8)
                and blob_ref[:len(mine)] == bytes(mine)), (
            f"shuff {name}: wire mismatch "
            f"({len(mine)} vs {len(blob_ref)})")
    else:
        parity.assert_blob_parity(method, mine, blob_ref)
    np.testing.assert_array_equal(
        codec.decode(blob_ref, n), data,
        err_msg=f"{method} {name}: our decode of the reference blob")
    np.testing.assert_array_equal(
        ref_decode(method, bytes(mine), n, tmp), data,
        err_msg=f"{method} {name}: reference decode of our blob")
    return "ok"


def _run_byte_case(name, data, tmp):
    """ans_byte codes the low byte of every value (ref_dump mirrors
    methods.hpp's u8 usage); decode returns u32s of those bytes."""
    n = len(data)
    lo = (data & 0xFF).astype(np.uint8)
    if len(np.unique(lo)) < 2:
        lo[0] ^= 1  # the reference hangs on single-symbol alphabets
        data = data.copy()
        data[0] = (data[0] & ~np.uint32(0xFF)) | lo[0]
    payload = lo.tobytes()
    codec = rc.AnsByte()
    try:
        blob_ref = ref_encode("byte", data, tmp)
        rt = ref_decode("byte", blob_ref, n, tmp)
        ref_self_ok = bool((rt.astype(np.uint8) == lo).all())
    except (RuntimeError, subprocess.TimeoutExpired):
        ref_self_ok = False
    if not ref_self_ok:
        mine = codec.encode(payload)
        assert codec.decode(mine, n) == payload, f"byte {name} (ours)"
        return "ref-defect"
    mine = codec.encode(payload)
    parity.assert_byte_blob_parity(bytes(mine), blob_ref)
    assert codec.decode(blob_ref, n) == payload, \
        f"byte {name}: our decode of the reference blob"
    rt2 = ref_decode("byte", bytes(mine), n, tmp)
    np.testing.assert_array_equal(
        rt2.astype(np.uint8), lo,
        err_msg=f"byte {name}: reference decode of our blob")
    return "ok"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--methods",
                    default=",".join(parity.METHODS + ["byte", "shuff"]))
    ap.add_argument("--keep-going", action="store_true")
    args = ap.parse_args()
    build_ref_dump()
    methods = args.methods.split(",")
    rng = np.random.default_rng(args.seed)
    ok = defect = failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.cases):
            method = methods[int(rng.integers(len(methods)))]
            name, data = gen_case(rng, method)
            try:
                r = run_case(method, name, data, tmp)
            except Exception as e:  # noqa: BLE001 - report + count
                failed += 1
                print(f"FAIL {method:8s} {name}: "
                      f"{type(e).__name__}: {str(e)[:300]}")
                if not args.keep_going:
                    sys.exit(1)
                continue
            ok += r == "ok"
            defect += r == "ref-defect"
            if (i + 1) % 10 == 0:
                print(f"  {i + 1}/{args.cases} "
                      f"(ok={ok} ref-defect={defect} fail={failed})",
                      flush=True)
    print(f"done: {ok} parity-ok, {defect} reference-defect "
          f"(ours round-tripped), {failed} failed")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
