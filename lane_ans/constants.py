"""Shared codec constants.

One module replaces the reference's per-coder constants namespaces
(reference: include/ans_byte.hpp:24-31 plus the dead duplicates in
ans_int.hpp:26-30, ans_msb.hpp:28-33, ans_fold.hpp:24-28, ...), all of which
actually resolve to the same values.
"""

# --- rANS state machine (reference-compatible math, "fmt B") -------------
# state is conceptually u64; renormalization emits 32-bit words.
RADIX_LOG2 = 32
RADIX = 1 << RADIX_LOG2
K = 16  # lower bound L = K * frame_size  (reference: ans_int.hpp:65)

# --- lane vector format ("fmt A"): u32 state, 8-bit renormalization ------
# state is u32 in [L, L*256); L = A_KM = K_A * frame_size with the product
# held constant so precision never drops below the reference's K=16 until
# frame_size exceeds 2**19.
A_RENORM_LOG2 = 8
A_KM_LOG2 = 23  # L = 1 << 23 (ryg-style); K_A = 2**23 / frame_size
A_MAX_FRAME_LOG2 = 22  # beyond this, fmt A precision is unacceptable -> fmt B

# --- magnitude folding -----------------------------------------------------
FOLD_RADIX = 8  # bytes are stripped (reference: ans_fold.hpp:40)
FOLD_RADIX_MASK = (1 << FOLD_RADIX) - 1

# msb coder bucket count (reference: ans_msb.hpp:29)
MSB_MAX_SIGMA = 1280

# byte coder (reference: ans_byte.hpp:24-31)
BYTE_MAX_SIGMA = 256
BYTE_MAX_FRAME_SIZE = 4096
BYTE_FRAME_FACTOR = 64

# unused in the reference but kept for parity (include/constants.hpp:18-20)
BLOCK_SIZE = 128


def fold_threshold(fidelity: int) -> int:
    """First value that triggers a byte strip: 2**(fidelity+7).

    reference: ans_fold.hpp:43 (thres = 1 << (fidelity + radix - 1)).
    """
    return 1 << (fidelity + FOLD_RADIX - 1)


def fold_offset_step(fidelity: int) -> int:
    """Bucket-offset added per stripped byte: 2**(fidelity-1) * 255.

    reference: ans_fold.hpp:47.
    """
    return (1 << (fidelity - 1)) * FOLD_RADIX_MASK


def fold_max_sigma(fidelity: int) -> int:
    """Folded alphabet bound 2**(fidelity+9) (reference: ans_fold.hpp:70)."""
    return 1 << (fidelity + FOLD_RADIX + 1)
