"""Device tracing hooks (the reference's profiling is min-of-N wall
clocks + RECORD_STATS, SURVEY.md section 5; on the device the equivalent
is a jax.profiler trace around the region of interest, reduced here to
per-operation device time and the device's busy share)."""

from __future__ import annotations

import contextlib
import glob
import os
import tempfile


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """Capture a jax.profiler trace (view with TensorBoard/XProf); by
    default under the temporary directory."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "lane_ans_trace")
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def summarize_trace(logdir: str, plane: str = "/device:GPU:0") -> dict:
    """Reduce the newest trace under `logdir` to the events of one plane.

    Returns {"events": count, "window_ns": first start to last end,
    "busy_ns": union of the event intervals, "ops": {name: (total_ns,
    count)}}.  busy / window is the plane's busy share over the traced
    region; 1 - that is its idle share."""
    from jax.profiler import ProfileData
    files = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace under {logdir}")
    pd = ProfileData.from_file(files[-1])
    ops: dict[str, tuple[int, int]] = {}
    spans = []
    for p in pd.planes:
        if p.name != plane:
            continue
        for line in p.lines:
            for ev in line.events:
                tot, cnt = ops.get(ev.name, (0, 0))
                ops[ev.name] = (tot + ev.duration_ns, cnt + 1)
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        raise ValueError(f"no events on plane {plane!r} in {files[-1]}")
    spans.sort()
    busy, (lo, hi) = 0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    window = max(e for _, e in spans) - spans[0][0]
    return {"events": len(spans), "window_ns": window, "busy_ns": busy,
            "ops": ops}
