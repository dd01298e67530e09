"""Headline benchmark: ANSfold-2 lane-engine decode throughput on the GPU.

Prints the device (`device_kind`, device count, and nvidia-smi's name and
power limit) and then ONE JSON line:
  {"metric": ..., "value": N, "unit": "ints/sec", "vs_baseline": N, ...}

Dataset: zipf(1.25), n = 2^25, seed 42.  The headline value is the
device-resident decode throughput via models.prepare_decoder (the fused
decode kernel on a GPU; honest frames = the reference's exact
adjust_freqs model, clamped only at the lane format's 2^22 ceiling):
compressed stream + tables staged in device memory once, the decode
timed over repeat runs (min of NUM_RUNS).  Device-resident encode
(models.prepare_encoder), one-shot end-to-end numbers and ANS on
zipf-2^20 are extra fields.

Baseline = the unmodified reference C++ ans_fold<2> decoder measured
single-core on an earlier host's CPU (BASELINE_MEASURED.json, produced by
tools/ref_harness.cpp), not on the machine this runs on; every
`*_vs_cpp` / `vs_baseline` ratio divides by those stored numbers.

Fails (non-zero exit) unless JAX's default device is a GPU.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N = 1 << 25
SEED = 42
NUM_RUNS = 5
METHOD = "ANSfold-2"
LANES = 4096


def make_data():
    rng = np.random.default_rng(SEED)
    return (rng.zipf(1.25, size=N) - 1).clip(0, (1 << 28) - 1).astype(
        np.uint32)


def _time(f, runs=NUM_RUNS):
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        f()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    from lane_ans import runtime
    runtime.enable_compilation_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's default device is "
                 f"{dev.platform!r}")
    print(f"device_kind={dev.device_kind} count={len(jax.devices())}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)

    from lane_ans import models
    from lane_ans.models.ans import AnsFold, AnsInt
    from lane_ans.utils import zipf as _zipf

    data = make_data()
    codec = AnsFold(2, lanes=LANES, max_frame=None)
    blob = codec.encode(data)                  # warmup + compile
    out = codec.decode(blob, N)
    assert (out == data).all(), "round-trip failed"
    bpi = 8.0 * len(blob) / N

    prep = models.prepare_decoder(METHOD, blob, N)
    prep().block_until_ready()
    dec_ips = N / _time(lambda: prep().block_until_ready())

    pe = models.prepare_encoder(METHOD, data, lanes=LANES)
    jax.block_until_ready(pe())
    enc_ips = N / _time(lambda: jax.block_until_ready(pe()))

    e2e_enc = _time(lambda: codec.encode(data), 2)
    e2e_dec = _time(lambda: codec.decode(blob, N), 2)

    # large-alphabet row: ANS (ans_int) on zipf-2^20 (escape/grouped
    # tables; sigma ~1M)
    zdata = _zipf.zipf(np.random.default_rng(0), N, 1 << 20)
    bblob = AnsInt(lanes=LANES).encode(zdata)
    bprep = models.prepare_decoder("ANS", bblob, N)
    assert (bprep.to_host(bprep()) == zdata).all(), "zipf20 round-trip"
    bd_ips = N / _time(lambda: bprep().block_until_ready())

    bp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "BASELINE_MEASURED.json")
    stored = json.load(open(bp))
    base = stored["methods"][METHOD]
    bm = stored["large_alphabet"]["datasets"]["zipf20"]["ANS"]

    print(json.dumps({
        "metric": f"{METHOD} decode ints/sec, device-resident lane "
                  f"engine ({prep.engine}), honest frame (zipf-1.25 "
                  f"n=2^{N.bit_length() - 1}, {dev.device_kind})",
        "value": round(dec_ips),
        "unit": "ints/sec",
        "vs_baseline": round(dec_ips / base["decode_ips"], 4),
        "bits_per_int": round(bpi, 4),
        "encode_ips": round(enc_ips),
        "encode_vs_baseline": round(enc_ips / base["encode_ips"], 4),
        "e2e_encode_ips": round(N / e2e_enc),
        "e2e_decode_ips": round(N / e2e_dec),
        "baseline_decode_ips": base.get("decode_ips"),
        "baseline_encode_ips": base.get("encode_ips"),
        "baseline_bpi": base.get("bpi"),
        "zipf20_ans_decode_ips": round(bd_ips),
        "zipf20_ans_bpi": round(8.0 * len(bblob) / N, 4),
        "zipf20_ans_vs_cpp": round(bd_ips / bm["decode_ips"], 2),
    }))


if __name__ == "__main__":
    main()
