"""Build the native backend:  python -m lane_ans.native.build"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "ans_native.cpp")
LIB = os.path.join(HERE, "libansnative.so")


def build(verbose: bool = True) -> str:
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
           "-fPIC", SRC, "-o", LIB]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    return LIB


if __name__ == "__main__":
    build()
    print(f"built {LIB}")
    sys.exit(0)
