"""GPU-only tests: the decode kernel as Triton compiles it for the card.

Every test takes the `gpu` fixture (conftest.py), so it skips unless
JAX's default backend is a GPU.  On a machine with a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

from lane_ans import models
from lane_ans.models.ans import AnsFold, AnsInt, AnsMsb

pytestmark = pytest.mark.gpu


def _values(kind: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    z = (rng.zipf(1.3, size=60000) - 1).clip(0, 1 << 27).astype(np.uint32)
    if kind == "sparse":
        return (z % 300).astype(np.uint32) * 7 + 3
    if kind == "grouped":
        return np.concatenate([np.arange(9000, dtype=np.uint32) * 3,
                               (z % 60000).astype(np.uint32)])
    return z


@pytest.mark.parametrize("name,codec,kind", [
    ("ANSfold-2", AnsFold(2, lanes=4096), "zipf"),
    ("ANSmsb", AnsMsb(lanes=256), "zipf"),
    ("ANS", AnsInt(lanes=128), "sparse"),
    ("ANS", AnsInt(lanes=1024), "grouped"),
    ("ANSfold-1", AnsFold(1, lanes=16), "zipf"),
])
def test_compiled_kernel_matches_xla(gpu, name, codec, kind):
    values = _values(kind)
    blob = codec.encode(values)
    n = len(values)
    kern = models.prepare_decoder(name, blob, n)
    assert kern.engine == "kernel"
    xla = models.prepare_decoder(name, blob, n, engine="xla")
    ko = np.asarray(kern())
    np.testing.assert_array_equal(ko, np.asarray(xla()))
    np.testing.assert_array_equal(kern.to_host(ko), values)


def test_blocked_codec_on_gpus(gpu):
    """BlockCodec over every visible card decodes through the kernel."""
    import jax

    from lane_ans.parallel import BlockCodec, make_mesh
    values = _values("zipf")
    codec = BlockCodec("ANSfold-2", make_mesh(len(jax.devices())))
    blob = codec.encode(values)
    np.testing.assert_array_equal(codec.decode(blob, len(values)), values)
