"""Registry-wide corrupt-wire sweep (SURVEY §5 failure handling).

For every wire-format family head, encode a small input and decode
deterministic mutations (truncations, byte flips/saturations/zeroes).
Any outcome is acceptable EXCEPT a crash or hang: correct output,
wrong-but-returned output, or a clean Python exception.  The native
backend is covered too (reference counterpart: the C++ coders SIGSEGV
or loop on several of these — hardening beyond parity, see commits
01ce1ae / 3e3cd1f and ADVICE round 2).
"""
import numpy as np
import pytest

from lane_ans import models

# one representative per wire family (compat = native/bit-exact paths);
# composites exercise the two-stage containers
METHODS = [
    "ANS", "ANSmsb", "ANSfold-2", "ANSfold-8", "ANSrfold-2",
    "ANSsint-80", "ANSsmsb-80", "arith", "fse", "huffzero", "shuff",
    "optpfor", "vbyte", "streamvbyte", "vbytefse", "streamvbyteANS",
    "entropy_only", "pseudo_adaptive",
]


def _mutations(blob: bytes):
    n = len(blob)
    yield blob[: n // 4]
    yield blob[: n // 2]
    yield blob[: n - 1]
    yield b""
    for pos in (0, 1, 3, 8, n // 2, n - 1):
        if pos < n:
            for val in (blob[pos] ^ 0xFF, 0xFF, 0x00):
                m = bytearray(blob)
                m[pos] = val
                yield bytes(m)


# the engine argument only changes codec resolution for the ANS*
# lane/compat families; host methods return the identical object for
# both, so sweeping them twice adds minutes for zero coverage
CASES = [(n, e) for n in METHODS
         for e in (("compat", "lane") if n.startswith("ANS") else
                   ("compat",))]


@pytest.mark.parametrize("name,engine", CASES)
def test_corrupt_wire_never_crashes(name, engine):
    rng = np.random.default_rng(0)
    data = np.minimum(rng.zipf(1.3, size=500), 1 << 20).astype(np.uint32)
    codec = models.get(name, engine)
    blob = bytes(codec.encode(data))
    for mut in _mutations(blob):
        try:
            codec.decode(np.frombuffer(mut, dtype=np.uint8), len(data))
        except Exception:
            pass  # clean rejection is a valid outcome
