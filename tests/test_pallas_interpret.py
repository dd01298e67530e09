"""Fused decode kernel (ops/lane_kernel.py) in the Pallas interpreter.

The kernel's correctness is shape- and format-sensitive (lockstep
rounds, packed rank fields, section-cut blobs, padded lanes); these
tests run it with interpret=True against the XLA scan engine's output
and against the input values.
"""

import numpy as np
import pytest

from lane_ans.models import framing
from lane_ans.models.ans import AnsFold, AnsInt, AnsMsb
from lane_ans.ops import tables
from lane_ans.reference_model import mappings as map_np
from lane_ans.reference_model.model import adjust_freqs, load_prelude

from kernel_cases import encode_staged, kernel_vs_xla, run_blob


@pytest.fixture(scope="module")
def zdata():
    rng = np.random.default_rng(5)
    return (rng.zipf(1.3, size=40000) - 1).clip(0, 1 << 27).astype(
        np.uint32)


def test_pallas_fold(zdata):
    run_blob("ANSfold-2", AnsFold(2, lanes=256), zdata)


def test_pallas_msb(zdata):
    run_blob("ANSmsb", AnsMsb(lanes=128), zdata[:20000])


def test_pallas_int(zdata):
    run_blob("ANS", AnsInt(lanes=128), (zdata % 3000).astype(np.uint32))


def test_pallas_ragged_tail(zdata):
    run_blob("ANSfold-1", AnsFold(1, lanes=128), zdata[: 128 * 37 + 5])


def test_pallas_multi_section(zdata):
    """A blob cut into several sections decodes the same way: the kernel
    reads the contiguous payload, states flow across the cuts."""
    values = zdata[:30000]
    S, f = 128, 2
    mapped = map_np.fold_map(values, f)
    k, b = map_np.fold_exceptions(values, f)
    freqs = np.bincount(mapped).astype(np.uint64)
    nfreqs = adjust_freqs(freqs, len(freqs) - 1, True, 1)
    stream, total, states, sb, T = encode_staged(mapped, k, b, nfreqs, S)
    t_sec, sec_len = framing.choose_sections(sb, total, T, cap_bytes=8192)
    assert len(sec_len) > 2
    blob = framing.pack(states, stream, t_sec, sec_len)
    _, st2, payload, _, _ = framing.parse(blob, 0)
    syms = np.arange(len(nfreqs), dtype=np.uint32)
    high, nb = map_np.fold_unmap_high(syms, f)
    dt = tables.build_dec_table(nfreqs, high, nb)
    kernel_vs_xla(payload, st2, dt, len(values), S, values)


def test_pallas_int_big_frame(zdata):
    """A large frame: per-slot tables of >= 2^15 entries gathered by
    slot."""
    rng = np.random.default_rng(11)
    v = np.concatenate([
        (zdata % 6000).astype(np.uint32),
        rng.integers(0, 6000, 20000).astype(np.uint32)])
    blob = run_blob("ANS", AnsInt(lanes=128), v)
    nfreqs, _ = load_prelude(blob)
    assert int(np.asarray(nfreqs).sum()) >= (1 << 15)
