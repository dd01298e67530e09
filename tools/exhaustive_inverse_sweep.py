"""Exhaustive u32 inverse sweep for the fold/msb mappings.

The reference checks every one of the 2^32 inputs in a scalar loop
(reference src/test.cpp:49-72: undo_mapping(mapping(x)) == x for
ans_fold fidelity 1..8 and ans_msb); tests/test_primitives.py keeps a
fast sampled version for CI.  This tool is the full-space pass,
vectorized in chunks: for every chunk it folds, strips exception bytes,
unfolds, and asserts bit-exact reconstruction — then writes the result
table to SWEEP_RESULT.md so the property is documented without a
40-minute test in every CI run.

    python tools/exhaustive_inverse_sweep.py
"""

from __future__ import annotations

import sys
import time
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from lane_ans.reference_model import mappings

CHUNK = 1 << 25


def sweep_fold(fidelity: int) -> int:
    checked = 0
    for lo in range(0, 1 << 32, CHUNK):
        x = np.arange(lo, lo + CHUNK, dtype=np.uint64).astype(np.uint32)
        sym = mappings.fold_map(x, fidelity)
        k, b = mappings.fold_exceptions(x, fidelity)
        high, nb = mappings.fold_unmap_high(sym, fidelity)
        if not (k == nb).all():
            raise AssertionError(f"fold-{fidelity}: nb mismatch @ {lo}")
        low = np.zeros(len(x), dtype=np.uint64)
        for j in range(3):
            low += np.where(j < k, b[:, j].astype(np.uint64) << (8 * j), 0)
        recon = (high.astype(np.uint64) + low).astype(np.uint32)
        if not (recon == x).all():
            bad = int(x[recon != x][0])
            raise AssertionError(f"fold-{fidelity}: wrong inverse for "
                                 f"{bad:#x}")
        checked += len(x)
    return checked


def sweep_msb() -> int:
    checked = 0
    for lo in range(0, 1 << 32, CHUNK):
        x = np.arange(lo, lo + CHUNK, dtype=np.uint64).astype(np.uint32)
        bucket = mappings.msb_map(x)
        k = mappings.msb_exception_bytes(bucket)
        high = mappings.msb_unmap_high(bucket)
        shift = (np.uint64(8) * k.astype(np.uint64))
        low = np.where(k > 0,
                       x.astype(np.uint64)
                       & ((np.uint64(1) << shift) - np.uint64(1)), 0)
        recon = (high.astype(np.uint64) + low).astype(np.uint32)
        if not (recon == x).all():
            bad = int(x[recon != x][0])
            raise AssertionError(f"msb: wrong inverse for {bad:#x}")
        checked += len(x)
    return checked


def main():
    rows = []
    for f in range(1, 9):
        t0 = time.time()
        n = sweep_fold(f)
        dt = time.time() - t0
        rows.append((f"fold-{f}", n, dt))
        print(f"fold-{f}: {n:,} values OK in {dt:.0f}s", flush=True)
    t0 = time.time()
    n = sweep_msb()
    dt = time.time() - t0
    rows.append(("msb", n, dt))
    print(f"msb: {n:,} values OK in {dt:.0f}s", flush=True)

    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "SWEEP_RESULT.md")
    with open(out, "w") as fh:
        fh.write("# Exhaustive inverse sweep (all 2^32 u32 inputs)\n\n")
        fh.write("`tools/exhaustive_inverse_sweep.py` — the full-space "
                 "version of tests/test_primitives.py's sampled "
                 "fold/msb inverse property (reference "
                 "src/test.cpp:49-72 does the same scalar sweep).  "
                 "Every u32 value folds, strips, and reconstructs "
                 "bit-exactly.\n\n")
        fh.write("| mapping | values checked | wall time |\n|---|---|---|\n")
        for name, n, dt in rows:
            fh.write(f"| {name} | {n:,} | {dt:.0f}s |\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
