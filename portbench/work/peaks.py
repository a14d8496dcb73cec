"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W power limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of fp32 outside the
tensor cores. A card set below 700 W runs slower under load; the run
prints its power limit beside every share of these."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of the work on the card: the larger of bytes over
    the memory rate and fp32 operations over the fp32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
