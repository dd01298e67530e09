"""Public staging APIs: models.prepare_decoder / prepare_encoder.

These are the serving entry points (and what the benchmark runs), so
the suite binds them directly: container identity with the one-shot
codec, engine choice and forcing, the interpreted decode kernel, and
clean rejection of bad inputs.
"""

import numpy as np
import pytest

from lane_ans import models
from lane_ans.models.ans import AnsFold


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    return (rng.zipf(1.3, size=30000) - 1).clip(0, 1 << 27).astype(
        np.uint32)


def test_prepare_decoder_xla_and_kernel(data):
    blob = AnsFold(2, lanes=256).encode(data)
    prep = models.prepare_decoder("ANSfold-2", blob, len(data))
    assert prep.engine == "xla"  # cpu backend -> xla
    np.testing.assert_array_equal(prep.to_host(prep()), data)
    prep2 = models.prepare_decoder("ANSfold-2", blob, len(data),
                                   engine="kernel", interpret=True)
    np.testing.assert_array_equal(prep2.to_host(prep2()), data)


def test_prepare_decoder_rejects(data):
    blob = AnsFold(2).encode(data[:4000])  # default lanes: S=32
    with pytest.raises(KeyError):
        models.prepare_decoder("vbyte", blob, 4000)
    with pytest.raises(ValueError):
        models.prepare_decoder("ANSfold-2", blob, 4000, engine="search")


def test_prepare_encoder_container_identity(data):
    pe = models.prepare_encoder("ANSfold-2", data, lanes=256)
    full = pe.prelude + pe.to_bytes(*pe())
    codec = AnsFold(2, lanes=256)
    assert bytes(full) == bytes(codec.encode(data))
    np.testing.assert_array_equal(codec.decode(full, len(data)), data)


def test_prepare_encoder_needs_envelope(data):
    """Any backend runs the prepared encoder; repeat calls are
    re-runnable without re-staging and give identical bytes; non-lane
    methods are rejected."""
    pe = models.prepare_encoder("ANSfold-2", data[:5000], lanes=128)
    assert pe.to_bytes(*pe()) == pe.to_bytes(*pe())
    with pytest.raises(KeyError):
        models.prepare_encoder("vbyte", data)
