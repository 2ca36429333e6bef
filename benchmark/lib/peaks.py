"""The card's peaks: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet,
dense rates without sparsity, at its full 700 W power limit."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12  # tensor cores
F32_FLOPS_PER_S = 67e12  # CUDA cores, outside the tensor cores
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def least_seconds(nbytes: float, flops: float, flops_per_s: float) -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at ``flops_per_s``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)
