"""Randomized lane-engine fuzz: the fused decode kernel in interpreter
mode vs the XLA scan engine vs the original data, plus the prepared
encoder vs the one-shot encoder.

tools/fuzz_parity.py proves the compat wire against the C++ oracle;
this covers the device side the oracle can't see: the fmt-2 lane wire,
the decode kernel and the staging logic, on random tables (random group
shapes, exception mixes, escape plans) rather than the fixed test
fixtures.  Runs on the CPU (interpret mode), so it is the pre-flight
check for new decode-kernel code before chip time.

Usage: python tools/fuzz_lane.py [--cases 40] [--seed 0] [--keep-going]
Exit 0 = every case round-tripped through both engines.
"""

from __future__ import annotations

import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])
sys.path.insert(0, __file__.rsplit("/", 1)[0])

import numpy as np

from fuzz_parity import gen_case  # noqa: E402 (shared case generator)

# lane method name -> fuzz_parity method token (value-domain caps etc.)
METHODS = {
    "ANS": "int", "ANSmsb": "msb",
    **{f"ANSfold-{f}": f"fold{f}" for f in (1, 2, 3, 4, 8)},
    **{f"ANSrfold-{f}": f"rfold{f}" for f in (1, 2, 4)},
    "ANSsint-80": "sint80", "ANSsmsb-320": "smsb320",
}


def run_case(name, case_name, data):
    """Returns the table kind the case exercised: 'grouped', 'escape'
    or 'plain'."""
    from lane_ans import models
    from lane_ans.ops import escape
    from lane_ans.reference_model.model import load_prelude
    codec = models.get(name, "lane")
    codec.lanes = 256  # small S keeps interpret mode fast
    n = len(data)
    blob = codec.encode(data)
    np.testing.assert_array_equal(codec.decode(blob, n), data,
                                  err_msg=f"{name} {case_name}: xla")
    kern = models.prepare_decoder(name, blob, n, engine="kernel",
                                  interpret=True)
    xla = models.prepare_decoder(name, blob, n, engine="xla")
    ko = np.asarray(kern())
    np.testing.assert_array_equal(
        ko, np.asarray(xla()), err_msg=f"{name} {case_name}: kernel!=xla")
    np.testing.assert_array_equal(kern.to_host(ko), data,
                                  err_msg=f"{name} {case_name}: kernel")
    pe = models.prepare_encoder(name, data, lanes=256)
    assert pe.prelude + pe.to_bytes(*pe()) == bytes(blob), (
        f"{name} {case_name}: prepared encode bytes differ")
    dt, _ = codec._dec_table(bytes(blob))
    if dt.layout is not None:
        return "grouped"
    if name == "ANS" or name.startswith("ANSsint"):
        nfreqs, _ = load_prelude(bytes(blob))
        if escape.plan_from_freqs(nfreqs) is not None:
            return "escape"
    return "plain"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--methods", default=",".join(METHODS))
    ap.add_argument("--keep-going", action="store_true")
    args = ap.parse_args()
    names = args.methods.split(",")
    rng = np.random.default_rng(args.seed)
    counts: dict[str, int] = {}
    failed = 0

    # guaranteed grouped-layout coverage: random cases rarely produce
    # the sigma >= 8193 live symbols that select the grouped layout
    # (ops/grouped.GROUPED_MIN_SIGMA), so seed three deterministic
    # large-alphabet cases up front (int-family only; mapped families
    # have small alphabets by construction)
    forced = []
    if "ANS" in names or "ANSsint-80" in names:
        g = np.random.default_rng(args.seed + 1)
        forced = [
            ("ANS", "forced-uniform14",
             g.integers(0, 1 << 14, size=20000).astype(np.uint32)),
            ("ANS", "forced-zipf17",
             np.concatenate([
                 np.arange(9000, dtype=np.uint32),  # sigma >= 9000
                 np.minimum(g.zipf(1.05, size=20000) - 1,
                            (1 << 17) - 1).astype(np.uint32)])),
            ("ANSsint-80", "forced-ramp",
             (np.arange(20000, dtype=np.uint32) % 12289)),
            # tail-escape recoding: byte-aligned zero-loss tail folds
            # the alphabet under 2^13
            ("ANS", "forced-escape",
             np.concatenate([
                 np.repeat(np.arange(2048, dtype=np.uint32), 8),
                 np.tile(np.arange(2048, 2048 + 10240,
                                   dtype=np.uint32), 2)])),
            # dense alphabet, alternating-freq tail (escape declines)
            # -> grouped layout
            ("ANS", "forced-anchored",
             np.concatenate([
                 np.arange(12288, dtype=np.uint32),
                 np.arange(0, 12288, 2, dtype=np.uint32)])),
        ]
    for name, case_name, data in forced:
        want = "escape" if case_name == "forced-escape" else "grouped"
        try:
            kind = run_case(name, case_name, data)
            assert kind == want, \
                f"{case_name}: expected {want} tables, got {kind}"
        except Exception as e:  # noqa: BLE001 - report + count
            failed += 1
            print(f"FAIL {name:10s} {case_name}: "
                  f"{type(e).__name__}: {str(e)[:300]}")
            if not args.keep_going:
                sys.exit(1)
            continue
        counts[kind] = counts.get(kind, 0) + 1

    for i in range(args.cases):
        name = names[int(rng.integers(len(names)))]
        case_name, data = gen_case(rng, METHODS[name])
        data = data[:20000]  # interpret mode is slow; bound the work
        if len(np.unique(data)) < 2:
            data[0] ^= 1
        try:
            kind = run_case(name, case_name, data)
        except Exception as e:  # noqa: BLE001 - report + count
            failed += 1
            print(f"FAIL {name:10s} {case_name}: "
                  f"{type(e).__name__}: {str(e)[:300]}")
            if not args.keep_going:
                sys.exit(1)
            continue
        counts[kind] = counts.get(kind, 0) + 1
        if (i + 1) % 5 == 0:
            print(f"  {i + 1}/{args.cases} tables={counts} "
                  f"fail={failed}", flush=True)
    print(f"done: {args.cases - failed} ok, {failed} failed; "
          f"table coverage {counts}")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
