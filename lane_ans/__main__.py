"""File CLI over the codec registry (self-describing ATFC container).

    python -m lane_ans compress   in.u32 out.atfc [-m ANSfold-2]
                                 [--engine lane|compat] [-t]
    python -m lane_ans decompress in.atfc out.u32
    python -m lane_ans info       in.atfc
    python -m lane_ans methods

Input .u32 files are little-endian u32 streams (the reference's data
format, src/table_efficiency.cpp); -t parses whitespace-separated text
integers instead.  The reference has no file compressor — its binaries
are experiment harnesses — so this is net framework surface.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import container, models


def _read_values(path: str, text: bool) -> np.ndarray:
    if text:
        with open(path) as f:
            return np.array(f.read().split(), dtype=np.uint32)
    return np.fromfile(path, dtype="<u4")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lane_ans")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="u32 file -> ATFC container")
    c.add_argument("infile")
    c.add_argument("outfile")
    c.add_argument("-m", "--method", default="ANSfold-2")
    c.add_argument("--engine", default="lane",
                   choices=("lane", "compat"))
    c.add_argument("-t", "--text", action="store_true",
                   help="parse whitespace-separated text integers")
    c.add_argument("--blocked", action="store_true",
                   help="ATFB container via the multi-device block "
                        "runtime (ANS-family methods)")
    c.add_argument("-D", "--devices", type=int, default=None,
                   help="mesh size for --blocked (default: all "
                        "visible devices)")

    d = sub.add_parser("decompress", help="ATFC container -> u32 file")
    d.add_argument("infile")
    d.add_argument("outfile")

    i = sub.add_parser("info", help="print container metadata")
    i.add_argument("infile")

    sub.add_parser("methods", help="list registry methods")

    args = ap.parse_args(argv)
    if args.cmd == "methods":
        for name in models.available():
            print(name)
        return 0
    if args.cmd == "compress":
        values = _read_values(args.infile, args.text)
        if values.size == 0:
            sys.exit("empty input")
        if args.blocked:
            from .parallel import block_runtime as br
            bc = br.BlockCodec(args.method, br.make_mesh(args.devices))
            out = bc.encode(values)
            desc = f"{args.method}, blocked D={bc.mesh.size}"
        else:
            out = container.compress(values, args.method, args.engine)
            desc = f"{args.method}, {args.engine}"
        with open(args.outfile, "wb") as f:
            f.write(out)
        print(f"{values.size} ints -> {len(out)} bytes "
              f"({8 * len(out) / values.size:.4f} bpi, {desc})")
        return 0
    buf = open(args.infile, "rb").read()
    from .parallel import block_runtime as br
    blocked = (len(buf) >= 4
               and int.from_bytes(buf[:4], "little") == br.MAGIC)
    if args.cmd == "info":
        if blocked:
            method, n, D = br.describe_container(buf)
            print(f"method={method} container=ATFB n={n} D={D} "
                  f"({8 * len(buf) / max(n, 1):.4f} bpi)")
        else:
            method, engine, n, blob = container.unpack(buf)
            print(f"method={method} engine={engine} n={n} "
                  f"payload={len(blob)} bytes "
                  f"({8 * len(blob) / max(n, 1):.4f} bpi)")
        return 0
    if blocked:
        # the stream holds one section per encode-mesh device; decode
        # needs a D-device mesh (CPU: XLA_FLAGS
        # --xla_force_host_platform_device_count=D)
        method, n, D = br.describe_container(buf)
        values = br.BlockCodec(method, br.make_mesh(D)).decode(buf)
    else:
        values = container.decompress(buf)
    values = np.ascontiguousarray(values, dtype=np.uint32)
    values.astype("<u4").tofile(args.outfile)
    print(f"{len(buf)} bytes -> {values.size} ints")
    return 0


if __name__ == "__main__":
    sys.exit(main())
