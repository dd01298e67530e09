"""End-to-end synthetic reproduction run -> RESULTS.md.

The reference's experiment flow (scripts/generate_data.sh +
src/table_effectiveness.cpp + src/table_efficiency.cpp) over the
synthetic half of its corpus: generate the 14 input families at a fixed
seed (drivers/generate_inputs — same distributions as
generate_inputs.cpp, PCG64 instead of mt19937, documented), then run
the full method registry over every file on BOTH engines:

  * compat — bit-exact reference wire format: its bits/int ARE the C++
    numbers (fixtures prove byte identity), so the table doubles as the
    reference comparison without rebuilding the C++ drivers;
  * lane   — the S-lane device format: the delta column is the price
    of device-parallel decode (state flush + sectioning).

Every (method, file) is round-trip verified.  Wall times are host CPU
(the XLA scan engine); this run is the effectiveness + correctness
sweep, not a speed measurement.

    JAX_PLATFORMS=cpu python tools/reproduce_synthetic.py [-n 1000000]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

METHODS = [
    "vbyte", "streamvbyte", "optpfor", "shuff", "arith", "fse",
    "huffzero", "vbytefse", "streamvbytefse", "vbytehuffzero",
    "streamvbytehuffzero", "vbyteANS", "streamvbyteANS", "entropy_only",
    "ANS", "ANSmsb",
    "ANSfold-1", "ANSfold-2", "ANSfold-3", "ANSfold-4",
    "ANSrfold-1", "ANSrfold-2", "ANSrfold-3", "ANSrfold-4",
    "ANSsint-5", "ANSsint-80", "ANSsmsb-5", "ANSsmsb-80",
]
ANS_FAMILY = {m for m in METHODS if m.startswith("ANS")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=1_000_000)
    ap.add_argument("-o", default=os.path.join(tempfile.gettempdir(),
                                              "lane_ans_synth"))
    args = ap.parse_args()

    from lane_ans import models
    from lane_ans.drivers import generate_inputs
    from lane_ans.utils import io, metrics

    files = generate_inputs.generate_all(args.o, args.n)
    inputs = [(os.path.basename(f)[:-4], io.read_input(f)) for f in files]

    results = {}  # (method, file) -> {engine: (bpi, enc_s, dec_s)}
    t_start = time.time()
    for mname in METHODS:
        engines = ("compat", "lane") if mname in ANS_FAMILY else ("host",)
        for engine in engines:
            codec = models.get(mname,
                               engine if engine != "host" else "lane")
            for fname, values in inputs:
                t0 = time.time()
                blob = codec.encode(values)
                t1 = time.time()
                if mname == "entropy_only":   # size bound, encode-only
                    t2 = t1                   # (methods.hpp:632-636)
                else:
                    out = codec.decode(blob, len(values))
                    t2 = time.time()
                    assert (np.asarray(out) == values).all(), \
                        f"round-trip failed: {mname}/{engine}/{fname}"
                results.setdefault((mname, fname), {})[engine] = (
                    8.0 * len(blob) / len(values), t1 - t0, t2 - t1)
            print(f"{mname} [{engine}] done "
                  f"({time.time() - t_start:.0f}s)", flush=True)

    fnames = [f for f, _ in inputs]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "RESULTS.md"), "w") as fh:
        fh.write("# Synthetic-corpus reproduction (bits/int, all "
                 "methods x 14 files)\n\n")
        fh.write(f"Generated by tools/reproduce_synthetic.py, n = "
                 f"{args.n:,} per file, seed 0 "
                 f"(drivers/generate_inputs — the reference's "
                 f"generate_inputs.cpp families).  Every cell is "
                 f"round-trip verified.  For the ANS family the "
                 f"`compat` engine writes byte-identical streams to "
                 f"the reference C++ (tests/test_reference_parity), "
                 f"so compat bpi = the reference's bpi; `lane` is the "
                 f"S-lane device format (delta = device-parallel "
                 f"decode overhead).  This sweep ran on the host CPU "
                 f"in {time.time() - t_start:.0f}s total.\n\n")
        for name, vals in inputs:
            fh.write(f"`{name}`: sigma={metrics.compute_sigma(vals)}, "
                     f"H0={metrics.compute_entropy(vals):.4f}\n\n")
        fh.write("## ANS family (compat = reference bpi | lane)\n\n")
        fh.write("| method | " + " | ".join(fnames) + " |\n")
        fh.write("|---" * (len(fnames) + 1) + "|\n")
        for m in METHODS:
            if m not in ANS_FAMILY:
                continue
            cells = []
            for f in fnames:
                c = results[(m, f)]["compat"][0]
                l = results[(m, f)]["lane"][0]
                cells.append(f"{c:.4f} \\| {l:.4f}")
            fh.write(f"| {m} | " + " | ".join(cells) + " |\n")
        fh.write("\n## Baselines (framework formats; reference uses "
                 "external C libs here)\n\n")
        fh.write("| method | " + " | ".join(fnames) + " |\n")
        fh.write("|---" * (len(fnames) + 1) + "|\n")
        for m in METHODS:
            if m in ANS_FAMILY:
                continue
            cells = [f"{results[(m, f)]['host'][0]:.4f}" for f in fnames]
            fh.write(f"| {m} | " + " | ".join(cells) + " |\n")
        fh.write("\n## Total encode+decode wall time per method "
                 "(14 files x n, host CPU)\n\n| method | engine | "
                 "encode s | decode s |\n|---|---|---|---|\n")
        for m in METHODS:
            engines = ("compat", "lane") if m in ANS_FAMILY else ("host",)
            for e in engines:
                enc = sum(results[(m, f)][e][1] for f in fnames)
                dec = sum(results[(m, f)][e][2] for f in fnames)
                fh.write(f"| {m} | {e} | {enc:.1f} | {dec:.1f} |\n")
    print("wrote RESULTS.md")


if __name__ == "__main__":
    main()
