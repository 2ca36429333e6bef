"""Input normalization (the port's counterpart of ``s2tpu/data/augment.py::normalize``).

The JAX package's optional space-to-depth packing is a TPU lane layout and
has no counterpart here.
"""

from __future__ import annotations

import torch


def normalize(
    images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """(..., C) raw DN -> standardized activations: f32 ``(x - mean) / std``,
    then a cast to the compute ``dtype``."""
    x = images.to(torch.float32)
    x = (x - mean.to(torch.float32)) / std.to(torch.float32)
    return x.to(dtype)
