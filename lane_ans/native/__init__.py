"""Native (C++) runtime bindings.

`lib` is None until the extension is built (python -m lane_ans.native.build);
all callers fall back to pure-Python paths when it is unavailable.
"""

lib = None

try:  # pragma: no cover - exercised only when the extension is built
    from .binding import NativeLib

    lib = NativeLib.try_load()
except Exception:  # pragma: no cover
    lib = None


def byte_histogram(arr):
    """256-bin u64 histogram of a uint8 array (native when built:
    ~15x np.bincount on MB-scale inputs)."""
    import numpy as np

    if lib is not None and len(arr):
        return lib.hist_u8(arr)
    return np.bincount(arr, minlength=256).astype(np.uint64)
