"""Multi-host runtime: real 2-process jax.distributed cluster on the
CPU backend (TCP coordination on localhost), 4 virtual devices per
process -> an 8-device global mesh split across two controllers.

This is the cross-host test SURVEY.md section 2.6 asks for: the
shared model must come from the cross-process histogram allreduce, so
every process's container shard carries a byte-identical prelude and
any process can decode any shard.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
port, pid = sys.argv[1], int(sys.argv[2])
import jax
jax.distributed.initialize(f"localhost:{port}", num_processes=2,
                           process_id=pid)
import numpy as np
from lane_ans.parallel import multihost as mh

assert jax.process_count() == 2
assert len(jax.devices()) == 8, jax.devices()

rng = np.random.default_rng(3)
values = (rng.zipf(1.3, size=16000) - 1).clip(0, 1 << 20).astype(
    np.uint32)
lo, hi = mh.local_block_slice(len(values))
codec = mh.MultiHostBlockCodec("ANSfold-2", lanes=32)
shard = codec.encode_local(values[lo:hi])
out = codec.decode_local(shard, hi - lo)
np.testing.assert_array_equal(out, values[lo:hi])

shards = mh.gather_container(shard)
assert len(shards) == 2
# shared model: every process decodes EVERY shard (preludes agree)
per = 8000
for i, s in enumerate(shards):
    l2, h2 = i * per, min((i + 1) * per, len(values))
    np.testing.assert_array_equal(codec.decode_local(s, h2 - l2),
                                  values[l2:h2])

# uncapped kind (ANS): per-shard maxima deliberately differ, so the
# histogram shape must come from the GLOBAL max collective
v2 = np.where(np.arange(len(values)) < 8000, values % 64,
              values % 100000).astype(np.uint32)
codec2 = mh.MultiHostBlockCodec("ANS", lanes=32)
shard2 = codec2.encode_local(v2[lo:hi])
np.testing.assert_array_equal(codec2.decode_local(shard2, hi - lo),
                              v2[lo:hi])
for i, s in enumerate(mh.gather_container(shard2)):
    l2, h2 = i * per, min((i + 1) * per, len(v2))
    np.testing.assert_array_equal(codec2.decode_local(s, h2 - l2),
                                  v2[l2:h2])
# rfold: the reorder permutation must be GLOBAL — skew the two shards
# so their local top-512 sets differ (a process-local craft_reorder
# would emit disagreeing headers and cross-shard decode would corrupt)
v3 = np.where(np.arange(len(values)) < 8000, values % 512,
              (values % 512) + 300).astype(np.uint32)
codec3 = mh.MultiHostBlockCodec("ANSrfold-2", lanes=32)
shard3 = codec3.encode_local(v3[lo:hi])
np.testing.assert_array_equal(codec3.decode_local(shard3, hi - lo),
                              v3[lo:hi])
for i, s in enumerate(mh.gather_container(shard3)):
    l2, h2 = i * per, min((i + 1) * per, len(v3))
    np.testing.assert_array_equal(codec3.decode_local(s, h2 - l2),
                                  v3[l2:h2])
# tail-escape recoding (ops/escape.py): sigma > 2^13 with a zero-loss
# byte-aligned tail, hot mass on shard 0 and tail mass on shard 1 so
# the LOCAL histograms disagree — the plan must derive from the global
# allreduced model on both processes or cross-shard decode corrupts
hot = np.repeat(np.arange(1024, dtype=np.uint32), 4)
tail = np.arange(1024, 1024 + 8192, dtype=np.uint32)
v4 = np.concatenate([hot, tail])  # shard 0 hot-heavy, shard 1 all tail
lo4, hi4 = mh.local_block_slice(len(v4))
per4 = -(-len(v4) // 2)
codec4 = mh.MultiHostBlockCodec("ANS", lanes=32)
shard4 = codec4.encode_local(v4[lo4:hi4])
np.testing.assert_array_equal(codec4.decode_local(shard4, hi4 - lo4),
                              v4[lo4:hi4])
for i, s in enumerate(mh.gather_container(shard4)):
    l2, h2 = i * per4, min((i + 1) * per4, len(v4))
    np.testing.assert_array_equal(codec4.decode_local(s, h2 - l2),
                                  v4[l2:h2])
print("MULTIHOST_OK", pid, flush=True)
"""


def test_two_process_cluster(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK {i}" in out, out[-3000:]


def test_single_process_fallbacks():
    """The same entry points run single-process (initialize no-op,
    gather returns the shard, slice covers everything)."""
    from lane_ans.parallel import multihost as mh
    mh.initialize()                      # no-op
    lo, hi = mh.local_block_slice(1000)
    assert (lo, hi) == (0, 1000)
    rng = np.random.default_rng(5)
    values = (rng.zipf(1.4, size=6000) - 1).clip(0, 1 << 20).astype(
        np.uint32)
    codec = mh.MultiHostBlockCodec("ANSmsb", lanes=32)
    shard = codec.encode_local(values)
    np.testing.assert_array_equal(codec.decode_local(shard, len(values)),
                                  values)
    assert mh.gather_container(shard) == [shard]
    # rfold single-process: global hist == local hist
    codec_r = mh.MultiHostBlockCodec("ANSrfold-2", lanes=32)
    shard_r = codec_r.encode_local(values)
    np.testing.assert_array_equal(
        codec_r.decode_local(shard_r, len(values)), values)
    with pytest.raises(ValueError, match="non-empty"):
        codec.encode_local(np.empty(0, np.uint32))
    # large alphabet (sigma > 2^13): the shared model selects the
    # frequency-grouped slot layout through the multihost entry points
    big = np.concatenate([np.arange(9000, dtype=np.uint32) * 2,
                          values]).astype(np.uint32)
    codec_g = mh.MultiHostBlockCodec("ANS", lanes=32)
    shard_g = codec_g.encode_local(big)
    np.testing.assert_array_equal(codec_g.decode_local(shard_g, len(big)),
                                  big)
