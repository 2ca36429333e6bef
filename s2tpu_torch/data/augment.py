"""Input normalization and the model-input layout (the port's counterparts of
``s2tpu/data/augment.py::normalize`` and ``SegmentationTrainer._model_input``).

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


def model_input(
    x: torch.Tensor, stack_time_into_channels: bool = False, squeeze_time_dim: bool = True
) -> torch.Tensor:
    """Normalized batch -> the model's input layout, as the JAX trainer's
    ``_model_input`` (``s2tpu/train/trainer.py:283-295``): (B, T, H, W, C)
    folds its frames into channels, frame-major, when
    ``stack_time_into_channels`` is set (the UNet's multi-temporal input);
    (B, H, W, C) gets T = 1 at axis 1 unless ``squeeze_time_dim`` (the ViT
    takes frames); anything else stays as it is, but frames for a
    ``squeeze_time_dim`` model, which are refused."""
    if x.dim() == 5 and stack_time_into_channels:
        b, t, h, w, c = x.shape
        return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)
    if x.dim() == 5 and squeeze_time_dim:
        raise ValueError("(B, T, H, W, C) input to a single-frame model needs stack_time_into_channels")
    if x.dim() == 4 and not squeeze_time_dim:
        return x[:, None]
    return x
