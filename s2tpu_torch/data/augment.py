"""Device-side flips, input normalization and the model-input layout (the
port's counterparts of ``s2tpu/data/augment.py`` and
``SegmentationTrainer._model_input``).

The flips draw from an explicit device generator that the trainer reseeds
for every (seed, step, micro-batch), as the JAX step folds those into its
augmentation key; the two frameworks' generators give other numbers from one
seed, so the flips agree with the JAX package's only where the draws decide
nothing (p = 0 and p = 1) or where the flags are given (:func:`apply_flips`).
The JAX package's optional space-to-depth packing is a TPU lane layout and
has no counterpart here.
"""

from __future__ import annotations

import torch

from s2tpu_torch.parallel.mesh import SINGLE, DataAxis


def normalize(
    images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """(..., C) raw DN -> standardized activations: f32 ``(x - mean) / std``,
    then a cast to the compute ``dtype``."""
    x = images.to(torch.float32)
    x = (x - mean.to(torch.float32)) / std.to(torch.float32)
    return x.to(dtype)


def apply_flips(
    images: torch.Tensor, labels: torch.Tensor | None, flip_h: torch.Tensor, flip_v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Per-sample flips of (B, [T,] H, W, C) images and (B, H, W) labels by
    the (B,) bool flags ``flip_h`` (left-right) and ``flip_v`` (up-down), as
    ``torch.where`` selects between the flipped and unflipped tensors: no
    shape depends on the flags. All frames of a sample flip together, and
    its labels with them."""
    shape = (images.shape[0],) + (1,) * (images.dim() - 1)
    images = torch.where(flip_h.reshape(shape), images.flip(-2), images)
    images = torch.where(flip_v.reshape(shape), images.flip(-3), images)
    if labels is not None:
        lshape = (labels.shape[0],) + (1,) * (labels.dim() - 1)
        labels = torch.where(flip_h.reshape(lshape), labels.flip(-1), labels)
        labels = torch.where(flip_v.reshape(lshape), labels.flip(-2), labels)
    return images, labels


def random_flips(
    images: torch.Tensor, labels: torch.Tensor | None, generator: torch.Generator,
    p_horizontal: float = 0.5, p_vertical: float = 0.5, data_axis: DataAxis = SINGLE,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Flip each sample left-right with probability ``p_horizontal`` and
    up-down with ``p_vertical`` (``s2tpu/data/augment.py:60-89``), the two
    (B,) uniform draws taken from ``generator`` in one call on the images'
    device; on a data axis, the global batch's draws, of which this rank
    keeps its columns."""
    u = torch.rand((2, images.shape[0] * data_axis.size), generator=generator, device=images.device)
    u = data_axis.local(u, dim=1)
    return apply_flips(images, labels, u[0] < p_horizontal, u[1] < p_vertical)


def augment_batch(
    images: torch.Tensor, labels: torch.Tensor | None, generator: torch.Generator | None,
    mean: torch.Tensor, std: torch.Tensor, p_horizontal: float = 0.5, p_vertical: float = 0.5,
    dtype: torch.dtype = torch.bfloat16, train: bool = True, data_axis: DataAxis = SINGLE,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The device transform of a batch (``s2tpu/data/augment.py:92-107``):
    flips when ``train`` (drawn for the global batch of ``data_axis``), then
    :func:`normalize`."""
    if train:
        images, labels = random_flips(images, labels, generator, p_horizontal, p_vertical, data_axis)
    return normalize(images, mean, std, dtype=dtype), labels


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
