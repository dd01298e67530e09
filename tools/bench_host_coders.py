"""Host coders (shuff, arith) vs the compiled reference, single core.

Measures OUR models/shuff.py and models/arith.py on the five standard
host-coder datasets and compares against the reference shuff.hpp /
arith.hpp rows stored in BASELINE_MEASURED.json "host_coders"
(measured by tools/ref_harness.cpp on an earlier host at the same n/seed —
the reference shuff fails its own round-trip at max symbol 2^27-1, so
its zipf125 row is clipped to 2^26-1; arith's maxv-sized F table makes
larger clips impractical).  Prints one row per (method, dataset).
The stored C++ rows were measured on an earlier host, so a ratio is
meaningful only for ours re-measured on a comparable core.

    JAX_PLATFORMS=cpu python tools/bench_host_coders.py [-n 25] [--runs 3]

Accelerator-free (pure host loops); run it on a quiet machine — these
are single-core numbers with a 5-10%% process-variance band.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def datasets(n):
    from lane_ans.utils import zipf as zm
    out = {}
    rng = np.random.default_rng(42)
    z = (rng.zipf(1.25, size=n) - 1).astype(np.uint64)
    out["zipf125c26"] = ("shuff",
                         np.minimum(z, (1 << 26) - 1).astype(np.uint32))
    out["zipf125c27"] = ("arith",
                         np.minimum(z, (1 << 27) - 1).astype(np.uint32))
    rng = np.random.default_rng(0)
    out["zipf20"] = (None, zm.zipf(rng, n, 1 << 20))
    rng = np.random.default_rng(0)
    out["uniform16"] = (None, rng.integers(0, 1 << 16, size=n,
                                           dtype=np.uint32))
    rng = np.random.default_rng(0)
    out["uniform20"] = (None, rng.integers(0, 1 << 20, size=n,
                                           dtype=np.uint32))
    rng = np.random.default_rng(0)
    out["words49k"] = (None, zm.zipf(rng, n, 49152))
    return out


def _best(f, runs):
    best = float("inf")
    r = None
    for _ in range(runs):
        t0 = time.perf_counter()
        r = f()
        best = min(best, time.perf_counter() - t0)
    return r, best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=25, help="log2 n")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    n = 1 << args.n

    from lane_ans import models
    base = json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "BASELINE_MEASURED.json")))["host_coders"]

    rows = []
    data = datasets(n)
    for method in ("shuff", "arith"):
        codec = models.get(method, "lane")
        for ds, (only, v) in data.items():
            if only is not None and only != method:
                continue
            blob, te = _best(lambda: codec.encode(v), args.runs)
            out, td = _best(lambda: codec.decode(blob, n), args.runs)
            assert (out == v).all(), (method, ds)
            bm = base.get(method, {}).get(ds)
            row = dict(
                method=method, dataset=ds,
                bpi=round(8.0 * len(blob) / n, 4),
                cpp_bpi=bm["bpi"] if bm else None,
                enc_mips=round(n / te / 1e6, 1),
                cpp_enc=round(bm["encode_ips"] / 1e6, 1) if bm else None,
                enc_ratio=round(n / te / bm["encode_ips"], 2)
                if bm else None,
                dec_mips=round(n / td / 1e6, 1),
                cpp_dec=round(bm["decode_ips"] / 1e6, 1) if bm else None,
                dec_ratio=round(n / td / bm["decode_ips"], 2)
                if bm else None)
            print(row, flush=True)
            rows.append(row)


if __name__ == "__main__":
    main()
