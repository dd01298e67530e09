"""Engine configuration: lane-count policy and format selection."""

from __future__ import annotations


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def validate_lanes(lanes: int | None) -> int | None:
    """Lane counts must be powers of two: the fmt-2 section header
    stores log2(S) (framing.pack)."""
    if lanes is not None and (lanes < 1 or lanes & (lanes - 1)):
        raise ValueError(f"lanes must be a power of two, got {lanes}")
    return lanes


def default_lane_count(n: int, min_lanes: int = 32,
                       max_lanes: int = 4096) -> int:
    """Lanes S for an n-element block.

    Each lane costs 4 bytes of flushed state, so S ~ n/12800 keeps the
    overhead small while exposing thousands of parallel states.  The
    cap is 4096 lanes: one fmt-2 stream decodes as S lockstep lanes, so
    S bounds a stream's decode parallelism, while every lane adds 4
    state bytes and a step touches all S lanes.  The n/12800 rule only
    reaches 4096 at n >= ~27M, where the 16KB state flush is < 0.01 bpi.
    Power of two, clamped.
    """
    if n <= 0:
        return min_lanes
    return min(max_lanes, max(min_lanes, next_pow2(-(-n // 12800))))
