"""NVIDIA's published H100 SXM peaks (data sheet, dense rates) at the
full 700 W power limit; a run prints the card's own limit beside them."""

HBM_BYTES_PER_S = 3.35e12   # HBM3 memory rate
FP32_OPS_PER_S = 67e12      # FP32 outside the tensor cores
FP64_OPS_PER_S = 34e12      # FP64 outside the tensor cores


def bound_s(ops, nbytes, ops_per_s=FP32_OPS_PER_S):
    """The least seconds the card could take for `ops` operations and
    `nbytes` bytes: the larger of the two times."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)
