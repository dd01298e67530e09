"""Trace one device-resident decode (the fused kernel and the XLA scan)
and one device-resident XLA encode of ANSfold-2 on zipf(1.25) data, and
print, per traced call, the device events, the busy share of the traced
window and the operations that take the most device time.

    python tools/trace_lane.py [--log2n 25] [--out DIR]

Needs a GPU (one process on one card).  The raw traces stay under
--out (default: the temporary directory) for TensorBoard/XProf.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=25)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "lane_ans_trace"))
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()

    import jax

    from lane_ans import models, runtime
    from lane_ans.utils.profiling import device_trace, summarize_trace
    runtime.enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU; JAX's default device is {dev.platform!r}",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)

    n = 1 << args.log2n
    rng = np.random.default_rng(42)
    vals = (rng.zipf(1.25, size=n) - 1).clip(0, (1 << 28) - 1).astype(
        np.uint32)
    blob = models.get("ANSfold-2").encode(vals)
    calls = {
        "kernel-decode": models.prepare_decoder("ANSfold-2", blob, n),
        "xla-decode": models.prepare_decoder("ANSfold-2", blob, n,
                                             engine="xla"),
        "xla-encode": models.prepare_encoder("ANSfold-2", vals),
    }
    for tag, fn in calls.items():
        jax.block_until_ready(fn())  # compile outside the trace
        t0 = time.perf_counter()
        with device_trace(os.path.join(args.out, tag)) as d:
            jax.block_until_ready(fn())
        wall = time.perf_counter() - t0
        s = summarize_trace(d, f"/device:GPU:{dev.id}")
        print(f"{tag}: n={n} traced wall {wall:.6f} s, device events "
              f"{s['events']}, busy {s['busy_ns'] / 1e6:.3f} ms of a "
              f"{s['window_ns'] / 1e6:.3f} ms window "
              f"({s['busy_ns'] / s['window_ns']:.3f})", flush=True)
        top = sorted(s["ops"].items(), key=lambda kv: -kv[1][0])
        for name, (tot, cnt) in top[:args.top]:
            print(f"{tag}   {tot / 1e6:10.3f} ms x {cnt:6d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
