"""GPU smoke test: the lane codec's main path at full size on one card.

    python chip_smoke.py              # phases a-h on one GPU
    python chip_smoke.py --chips 4    # the shared-model BlockCodec on four

Runs in one process (nvidia-smi is the only child).  Every phase prints
one line; any failure exits non-zero before the result line.  The last
line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

One card, n = 2^25 uint32 values in one fmt-2 stream of S = 4096 lanes:
  a  ANSfold-2 on zipf(1.25), seed 42, through models.get: round-trip, bpi
  b  ANS on zipf-2^20 (escape/grouped tables): round-trip
  c  prepare_decoder on a's blob: the decode kernel's output equals the
     XLA scan's, bit for bit, and the input
  d  prepare_encoder on a's data: blob equals codec.encode's, byte for byte
  e  ANSfold-2 and ANS encode of the first 2^20 values: GPU blobs equal
     the blobs the same code makes on the CPU backend
  f  the compat engine decodes the committed reference-binary blobs
  g  vbyte and streamvbyte round-trip
  h  decode kernel against the XLA scan on a's and b's data: median of 5
     timed runs each, device-resident encode time, peak device memory

--chips 4: BlockCodec("ANSfold-2") over a 4-card mesh encodes and
decodes 2^28 zipf(1.25) values (histogram psum over the cards); the
control is a one-card BlockCodec on the same input.  Both must
round-trip and carry the same prelude bytes.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import struct
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

N = 1 << 25
N_CPU = 1 << 20
N_MULTI = 1 << 28
N_MULTI_SMALL = 1 << 26
RUNS = 5


def zipf125(n: int, seed: int = 42) -> np.ndarray:
    """bench.py's dataset: zipf(1.25) - 1, clipped below 2^28."""
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.25, size=n) - 1).clip(0, (1 << 28) - 1).astype(
        np.uint32)


def zipf20(n: int) -> np.ndarray:
    from lane_ans.utils import zipf as _zipf
    return _zipf.zipf(np.random.default_rng(0), n, 1 << 20)


def median_time(f, runs: int = RUNS) -> float:
    f()  # warm-up (compiles)
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        f()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def phase(name: str, msg: str) -> None:
    print(f"phase {name}: {msg}", flush=True)


# -- one card ----------------------------------------------------------------

def one_card(dev) -> None:
    import jax

    from lane_ans import models
    from lane_ans.models.ans import AnsFold, AnsInt

    fold = zipf125(N)
    fcodec = models.get("ANSfold-2")
    t0 = time.perf_counter()
    fblob = fcodec.encode(fold)
    t_enc = time.perf_counter() - t0
    check((fcodec.decode(fblob, N) == fold).all(), "a: round-trip")
    prep = models.prepare_decoder("ANSfold-2", fblob, N)
    check(prep.S == 4096, f"a: S={prep.S}")
    phase("a", f"ANSfold-2 zipf(1.25) n={N} S={prep.S} round-trip ok, "
               f"bpi={8 * len(fblob) / N:.4f}, first encode "
               f"{t_enc:.3f} s")

    big = zipf20(N)
    bcodec = models.get("ANS")
    t0 = time.perf_counter()
    bblob = bcodec.encode(big)
    t_benc = time.perf_counter() - t0
    check((bcodec.decode(bblob, N) == big).all(), "b: round-trip")
    phase("b", f"ANS zipf-2^20 n={N} round-trip ok, "
               f"bpi={8 * len(bblob) / N:.4f}, first encode "
               f"{t_benc:.3f} s")

    check(prep.engine == "kernel", f"c: engine {prep.engine}")
    ko = np.asarray(prep())
    xla = models.prepare_decoder("ANSfold-2", fblob, N, engine="xla")
    xo = np.asarray(xla())
    check(ko.shape == xo.shape and (ko == xo).all(), "c: kernel != xla")
    check((prep.to_host(ko) == fold).all(), "c: kernel != input")
    phase("c", f"decode kernel == XLA scan bit for bit on {ko.shape} "
               f"and == input")

    pe = models.prepare_encoder("ANSfold-2", fold, lanes=4096)
    check(pe.prelude + pe.to_bytes(*pe()) == fblob,
          "d: prepare_encoder blob != codec.encode blob")
    phase("d", "prepare_encoder blob == codec.encode blob byte for byte")

    cpu = jax.devices("cpu")[0]
    for name, codec, vals in (("ANSfold-2", AnsFold(2), fold),
                              ("ANS", AnsInt(), big)):
        part = np.ascontiguousarray(vals[:N_CPU])
        on_gpu = codec.encode(part)
        with jax.default_device(cpu):
            on_cpu = codec.encode(part)
        check(on_gpu == on_cpu, f"e: {name} GPU blob != CPU blob")
    phase("e", f"ANSfold-2 and ANS blobs at n={N_CPU}: GPU == CPU "
               f"backend")

    fix = ROOT / "tests" / "fixtures"
    compat = {"int": "ANS", "msb": "ANSmsb", "sint80": "ANSsint-80",
              "smsb80": "ANSsmsb-80", "shuff": "shuff",
              **{f"fold{f}": f"ANSfold-{f}" for f in range(1, 9)},
              **{f"rfold{f}": f"ANSrfold-{f}" for f in range(1, 9)}}
    checked = 0
    for ref in sorted(fix.glob("*.ref")):
        dname, method = ref.stem.split(".")
        if method not in compat:
            continue  # ans_byte blobs carry bytes, not u32 values
        data = np.fromfile(fix / f"{dname}.u32", dtype="<u4")
        out = models.get(compat[method], "compat").decode(
            ref.read_bytes(), len(data))
        check((np.asarray(out) == data).all(), f"f: {ref.name}")
        checked += 1
    check(checked > 0, "f: no fixtures")
    phase("f", f"compat engine decodes {checked} reference-binary blobs")

    for name in ("vbyte", "streamvbyte"):
        codec = models.get(name)
        check((codec.decode(codec.encode(fold), N) == fold).all(),
              f"g: {name}")
    phase("g", f"vbyte and streamvbyte round-trip at n={N}")

    for name, method, blob, vals in (("fold2", "ANSfold-2", fblob, fold),
                                     ("zipf20", "ANS", bblob, big)):
        kp = models.prepare_decoder(method, blob, N)
        xp = models.prepare_decoder(method, blob, N, engine="xla")
        kout = kp()
        check((np.asarray(kout) == np.asarray(xp())).all()
              and (kp.to_host(kout) == vals).all(), f"h: {name} outputs")
        tk = median_time(lambda: kp().block_until_ready())
        tx = median_time(lambda: xp().block_until_ready())
        pe = models.prepare_encoder(method, vals, lanes=4096)
        te = median_time(lambda: jax.block_until_ready(pe()))
        phase("h", f"{name}: decode kernel {tk:.6f} s ({N / tk:.4g} "
                   f"ints/s), XLA scan {tx:.6f} s ({N / tx:.4g} ints/s), "
                   f"kernel/XLA speedup {tx / tk:.3f}; device-resident "
                   f"XLA encode {te:.6f} s ({N / te:.4g} ints/s); "
                   f"peak_bytes_in_use {peak_bytes(dev)}")


# -- four cards --------------------------------------------------------------

def _prelude(blob: bytes) -> bytes:
    """The model prelude of an ANSfold ATFB container (header: magic, ver,
    kind, fidelity, h_approx, n, D; then u32 length + prelude)."""
    (plen,) = struct.unpack_from("<I", blob, 16)
    return blob[20:20 + plen]


def _blocked(n_dev: int, vals: np.ndarray):
    from lane_ans.parallel import BlockCodec, make_mesh
    codec = BlockCodec("ANSfold-2", make_mesh(n_dev))
    t0 = time.perf_counter()
    blob = codec.encode(vals)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = codec.decode(blob, len(vals))
    t_dec = time.perf_counter() - t0
    check((out == vals).all(), f"D={n_dev}: round-trip")
    return blob, t_enc, t_dec


def four_cards(devs) -> None:
    check(len(devs) == 4, f"--chips 4 needs 4 GPUs, found {len(devs)}")
    vals = zipf125(N_MULTI)
    blob4, e4, d4 = _blocked(4, vals)
    phase("4-card", f"D=4 n={len(vals)} round-trip ok, bpi="
                    f"{8 * len(blob4) / len(vals):.4f}, first encode "
                    f"{e4:.3f} s, first decode {d4:.3f} s")
    try:
        blob1, e1, d1 = _blocked(1, vals)
    except Exception as e:  # the one-card control may not fit at 2^28
        if "RESOURCE_EXHAUSTED" not in str(e):
            raise
        phase("1-card", f"control at n={len(vals)} out of memory "
                        f"(peak_bytes_in_use {peak_bytes(devs[0])}); "
                        f"comparing at n={N_MULTI_SMALL}")
        vals = vals[:N_MULTI_SMALL]
        blob4, _, _ = _blocked(4, vals)
        blob1, e1, d1 = _blocked(1, vals)
    check(_prelude(blob4) == _prelude(blob1), "D=4 and D=1 preludes differ")
    phase("1-card", f"D=1 control n={len(vals)} "
                    f"round-trip ok, first encode {e1:.3f} s, first "
                    f"decode {d1:.3f} s; prelude identical to D=4 "
                    f"({len(_prelude(blob1))} bytes); peak_bytes_in_use "
                    f"{[peak_bytes(d) for d in devs[:4]]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()

    import jax
    # the CPU backend stays reachable beside the GPU (phase e)
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", f"{platforms},cpu")
    from lane_ans import runtime
    runtime.enable_compilation_cache()

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's default device is {devs[0].platform!r}",
              file=sys.stderr)
        return 1
    print(f"device_kind: {devs[0].device_kind}, count {len(devs)}",
          flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)

    if args.chips == 4:
        four_cards(devs)
    else:
        one_card(devs[0])
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
