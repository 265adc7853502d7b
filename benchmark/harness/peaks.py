"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the yardstick of every roofline share."""

PEAK_FP32_FLOPS = 67e12          # float32 outside the tensor cores, FLOP/s
PEAK_HBM_BYTES = 3.35e12         # HBM3, bytes/s


def least_seconds(flops: int, nbytes: int) -> float:
    """The least time the card could take for this work."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
