"""Paper Figures 11 and 12 reproductions -> RESULTS_FIG11.md / _FIG12.md.

Figure 11 (reference src/fold_effectiveness.cpp:132-148): bits/int vs
fold fidelity f = 1..8 for ANSfold and ANSrfold, per dataset — shows
the fidelity/effectiveness trade of the fold bucketing.

Figure 12 (reference src/benchmark.cpp:156-192): bits/int vs the
adjust_freqs entropy-approximation knob H_approx in {1, 5, 10, 20, 40,
80, 160, 320} permil for ANSsint/ANSsmsb — the space/approximation
sweep (larger H_approx = smaller frames = worse bpi, faster tables).

Datasets: the synthetic corpus families of drivers/generate_inputs
(fixed seed), the ones the reference's figures use shapes of.  Every
cell is round-trip verified (the reference's fold_effectiveness is
encode-only; verification here is extra).  Runs on the CPU; the
compat engine's bpi IS the reference's bpi (byte-identical wire).

    JAX_PLATFORMS=cpu python tools/reproduce_figures.py [-n 1000000]
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

FIG11_FILES = ["uniform12", "uniform20", "geom0.9", "zipf12", "zipf20",
               "docid-gaps"]
FIG12_FILES = FIG11_FILES
H_GRID = (1, 5, 10, 20, 40, 80, 160, 320)


def _inputs(n):
    from lane_ans.drivers import generate_inputs
    from lane_ans.utils import io, zipf
    out_dir = os.path.join(tempfile.gettempdir(), "lane_ans_figs")
    files = generate_inputs.generate_all(out_dir, n)
    inputs = {os.path.basename(f)[:-4]: io.read_input(f) for f in files}
    # docid-gaps: the clustered postings-gap shape of the speed corpus
    rng = np.random.default_rng(7)
    gaps = zipf.zipf(rng, n, 1 << 16)
    inputs["docid-gaps"] = gaps
    return inputs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=1_000_000)
    args = ap.parse_args()
    from lane_ans import models

    inputs = _inputs(args.n)
    t0 = time.time()

    # ---- Figure 11: bpi vs fidelity --------------------------------
    lines = [
        "# Figure 11 reproduction: bits/int vs fold fidelity",
        "",
        f"tools/reproduce_figures.py, n = {args.n:,} per file, compat "
        "engine (byte-identical to the reference wire, so these ARE "
        "the reference's numbers; reference "
        "src/fold_effectiveness.cpp:132-148).  Every cell round-trip "
        "verified — the reference's driver is encode-only.",
        ""]
    for fam in ("ANSfold", "ANSrfold"):
        lines += [f"## {fam}", "",
                  "| dataset | " + " | ".join(f"f={f}" for f in
                                              range(1, 9)) + " |",
                  "|---|" + "---|" * 8]
        for ds in FIG11_FILES:
            v = inputs[ds]
            cells = []
            for f in range(1, 9):
                codec = models.get(f"{fam}-{f}", "compat")
                blob = codec.encode(v)
                assert (codec.decode(blob, len(v)) == v).all(), (fam, f, ds)
                cells.append(f"{8.0 * len(blob) / len(v):.4f}")
            lines.append(f"| {ds} | " + " | ".join(cells) + " |")
            print(f"fig11 {fam} {ds} done", flush=True)
        lines.append("")
    open("RESULTS_FIG11.md", "w").write("\n".join(lines) + "\n")
    print("wrote RESULTS_FIG11.md", flush=True)

    # ---- Figure 12: bpi vs H_approx --------------------------------
    lines = [
        "# Figure 12 reproduction: bits/int vs adjust_freqs H_approx",
        "",
        f"tools/reproduce_figures.py, n = {args.n:,} per file, compat "
        "engine (reference src/benchmark.cpp:156-192 grid; H_approx "
        "is the permitted cross-entropy excess in permil of H0 — "
        "larger values stop the frame-size search earlier: smaller "
        "tables, worse bpi).  Every cell round-trip verified.",
        ""]
    for fam in ("ANSsint", "ANSsmsb"):
        lines += [f"## {fam}", "",
                  "| dataset | " + " | ".join(f"H={h}" for h in H_GRID)
                  + " |",
                  "|---|" + "---|" * len(H_GRID)]
        for ds in FIG12_FILES:
            v = inputs[ds]
            cells = []
            for h in H_GRID:
                codec = models.get(f"{fam}-{h}", "compat")
                blob = codec.encode(v)
                assert (codec.decode(blob, len(v)) == v).all(), (fam, h, ds)
                cells.append(f"{8.0 * len(blob) / len(v):.4f}")
            lines.append(f"| {ds} | " + " | ".join(cells) + " |")
            print(f"fig12 {fam} {ds} done", flush=True)
        lines.append("")
    open("RESULTS_FIG12.md", "w").write("\n".join(lines) + "\n")
    print(f"wrote RESULTS_FIG12.md ({time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
