"""utils/profiling: a traced call reduces to per-operation device time and
a busy share no larger than its window."""

import jax
import jax.numpy as jnp
import pytest

from lane_ans.utils.profiling import device_trace, summarize_trace


def test_summarize_trace_of_cpu_call(tmp_path):
    f = jax.jit(lambda x: jnp.cumsum(x * 2) + 1)
    x = jnp.ones(4096, jnp.int32)
    f(x).block_until_ready()
    with device_trace(str(tmp_path)) as d:
        f(x).block_until_ready()
    s = summarize_trace(d, "/host:CPU")
    assert s["events"] == sum(c for _, c in s["ops"].values()) > 0
    assert 0 < s["busy_ns"] <= s["window_ns"]
    with pytest.raises(ValueError):
        summarize_trace(d, "/device:GPU:0")
