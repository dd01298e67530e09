"""Lane-format blob framing (docs/FORMAT.md section 2, fmt 2).

After the method header + prelude (identical to the compat format) comes:

    u8  fmt          (2 = lockstep: u32 state, 8-bit renorm, shared stream)
    u8  log2(S)
    u16 num_sections (>= 1)
    u32 stream_len   little-endian
    u32 t_sec        steps per section (multiple of 32; last may be short)
    u32 section_len[num_sections]   bytes per section
    u32 init_state[S]    (final encoder states)
    shared stream bytes (= concatenated sections; decode reads forward)

Sections cut the stream at step boundaries so a decoder can stream one
bounded chunk at a time; lane states flow continuously across section
boundaries (a cut is only a byte-offset checkpoint).  The decode engines
here read the contiguous payload and need no cuts; encoders still emit
them, as part of the wire.
"""

from __future__ import annotations

import numpy as np

FMT_LOCKSTEP = 2


def pack(states: np.ndarray, stream: np.ndarray, t_sec: int,
         sec_len: np.ndarray) -> bytes:
    S = len(states)
    log2s = S.bit_length() - 1
    assert 1 << log2s == S
    nsec = len(sec_len)
    out = bytearray()
    out += bytes((FMT_LOCKSTEP, log2s))
    out += int(nsec).to_bytes(2, "little")
    out += int(len(stream)).to_bytes(4, "little")
    out += int(t_sec).to_bytes(4, "little")
    out += np.asarray(sec_len, dtype="<u4").tobytes()
    out += np.asarray(states, dtype="<u4").tobytes()
    out += np.asarray(stream, dtype=np.uint8).tobytes()
    return bytes(out)


def parse(buf: bytes, off: int):
    """Returns (S, states u32 (S,), stream u8 view, t_sec, sec_len)."""
    fmt, log2s = buf[off], buf[off + 1]
    if fmt != FMT_LOCKSTEP:
        raise ValueError(f"unknown lane format {fmt}")
    S = 1 << log2s
    nsec = int.from_bytes(buf[off + 2:off + 4], "little")
    stream_len = int.from_bytes(buf[off + 4:off + 8], "little")
    t_sec = int.from_bytes(buf[off + 8:off + 12], "little")
    p = off + 12
    sec_len = np.frombuffer(buf, dtype="<u4", count=nsec, offset=p).astype(
        np.int64)
    p += 4 * nsec
    states = np.frombuffer(buf, dtype="<u4", count=S, offset=p).copy()
    p += 4 * S
    stream = np.frombuffer(buf, dtype=np.uint8, count=stream_len, offset=p)
    return S, states, stream, t_sec, sec_len


def overhead_bytes(S: int, nsec: int = 1) -> int:
    return 12 + 4 * nsec + 4 * S


def pack_encoded(stream, total, states, step_base, T: int) -> bytes:
    """framing.pack of one lane_codec.encode_lanes result (device or
    host arrays): trims the stream to its total and cuts the sections."""
    total = int(total)
    t_sec, sec_len = choose_sections(np.asarray(step_base), total, T)
    return pack(np.asarray(states), np.asarray(stream[:total]), t_sec,
                sec_len)


def choose_sections(step_base: np.ndarray, total: int, T: int,
                    cap_bytes: int = 3 << 20, quantum: int = 32):
    """Pick t_sec (multiple of `quantum`) so every aligned section of
    t_sec steps spans <= cap_bytes; returns (t_sec, sec_len array)."""
    if T == 0:
        return quantum, np.array([total], dtype=np.int64)
    t_sec = -(-T // quantum) * quantum
    bounds = np.append(step_base, total)
    while True:
        cuts = np.arange(0, T, t_sec)
        ends = np.minimum(cuts + t_sec, T)
        lens = bounds[ends] - bounds[cuts]
        if lens.max() <= cap_bytes or t_sec <= quantum:
            return t_sec, lens.astype(np.int64)
        t_sec = max(quantum, (t_sec // 2 // quantum) * quantum)
