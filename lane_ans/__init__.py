"""lane_ans: large-alphabet semi-static ANS entropy coding on accelerators.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference C++ codebase (mpetri/ans-large-alphabet): the full semi-static
codec family (ans_int, ans_msb, ans_fold, ans_reorder_fold, ans_sint,
ans_smsb, ans_byte, arith, shuff, vbyte/streamvbyte composites), the
interpolative-coded prelude machinery, experiment drivers, and a
multi-device block runtime over jax.sharding meshes.
"""

__version__ = "0.1.0"
