"""Pseudo-adaptive block codec tests (paper Figure 13 workload).

The reference's pseudo_adaptive.cpp is encode-only; these tests cover the
full round-trip our implementation adds, plus the single-symbol-block
shortcut (pseudo_adaptive.cpp:120) and the BPI-vs-block-size tradeoff.
"""

import numpy as np
import pytest

from lane_ans.models.pseudo_adaptive import PseudoAdaptive


@pytest.fixture(scope="module")
def drifting():
    """Input whose local statistics drift, so per-block models win."""
    rng = np.random.default_rng(3)
    parts = []
    for i in range(8):
        base = i * 1000
        parts.append(rng.integers(base, base + 50, size=4000))
    return np.concatenate(parts).astype(np.uint32)


@pytest.mark.parametrize("kind", ["int", "msb"])
@pytest.mark.parametrize("block_size", [128, 4096, 1 << 20])
def test_roundtrip(drifting, kind, block_size):
    codec = PseudoAdaptive(block_size, kind, lanes=32)
    blob = codec.encode(drifting)
    np.testing.assert_array_equal(codec.decode(blob, len(drifting)),
                                  drifting)


def test_single_symbol_blocks():
    v = np.repeat(np.arange(16, dtype=np.uint32), 128)  # 1 symbol per block
    codec = PseudoAdaptive(128, "int", lanes=32)
    blob = codec.encode(v)
    # each block stores only sigma=1 + the symbol: tiny
    assert len(blob) < 16 + 16 * 8
    np.testing.assert_array_equal(codec.decode(blob), v)


def test_adaptive_beats_global_on_drifting_data(drifting):
    from lane_ans import models
    codec = PseudoAdaptive(4096, "int", lanes=32)
    adaptive = len(codec.encode(drifting))
    global_ = len(models.get("ANS", "compat").encode(drifting))
    assert adaptive < global_


def test_any_instance_decodes_any_container():
    """kind + engine are wire facts recorded in the ATFP header
    (regression: decode used self.kind/self.block_size, so a
    default-constructed instance mis-decoded or crashed on containers
    from differently-configured encoders)."""
    import numpy as np
    from lane_ans.models.pseudo_adaptive import PseudoAdaptive
    rng = np.random.default_rng(9)
    v = (rng.zipf(1.5, 5000) - 1).clip(0, 1 << 20).astype(np.uint32)
    v[:600] += 300  # per-block sigma > 256 somewhere
    for enc_cfg in [dict(block_size=1024, kind="msb"),
                    dict(block_size=1 << 17, kind="int"),
                    dict(block_size=2048, kind="int", engine="lane",
                         lanes=32)]:
        blob = PseudoAdaptive(**enc_cfg).encode(v)
        out = PseudoAdaptive().decode(blob, len(v))   # default instance
        np.testing.assert_array_equal(out, v)
