"""Device-side ops: table building, lane-format rANS kernels, histograms.

The compute-path counterpart of the reference's hand-tuned scalar C++
inner loops (reference: include/ans_int.hpp, ans_fold.hpp, ...): here they
are vectorized over S independent ANS lanes and run under jit on the
accelerator (XLA engine in lane_codec; the fused GPU decode kernel in
lane_kernel).
"""

from . import tables  # noqa: F401
from . import lane_codec  # noqa: F401
