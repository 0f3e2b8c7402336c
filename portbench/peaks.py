"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at its full
700 W power limit (NVIDIA's data sheet).  A roofline share or an mfu is
stated against these, with the card's power limit beside it."""

F32_FLOPS = 67e12      # float32 outside the tensor cores
TF32_FLOPS = 495e12    # TF32 tensor cores
BF16_FLOPS = 989e12    # bfloat16 / float16 tensor cores
F64_FLOPS = 67e12      # float64 tensor cores
HBM_BYTES = 3.35e12    # HBM3 bandwidth, bytes/s
F32 = 4                # bytes of a float32


def bound_s(ops: float, nbytes: float, flops: float = F32_FLOPS) -> float:
    """The least time the card could take: the larger of the operations
    at ``flops`` and the bytes at the HBM bandwidth."""
    return max(ops / flops, nbytes / HBM_BYTES)
