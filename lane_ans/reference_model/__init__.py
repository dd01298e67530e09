"""NumPy golden model: bit-exact re-expression of the reference wire formats.

Everything here is host-side, sequential, and test-oriented; it is the
oracle against which the device lane codecs (lane_ans.ops / lane_ans.models)
are validated.
"""

from . import bitio, interp, mappings, model, rans_compat, vbyte  # noqa: F401
