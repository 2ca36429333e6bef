"""Loss zoo: masked/weighted CE, focal, soft-dice, combined (the port of ``s2tpu/train/losses.py``).

The same four loss types over (B, H, W, K) channel-last logits, with
``ignore_index = 0`` under ``masked_loss``, the ``w = 1 - p`` class weights
and ``batch_mask`` for padded eval batches. Without label smoothing, CE and
focal (alone or inside ``dice_focal``) run the fused kernels of
``ops/fused_ce.py`` (#3 forward, #4 backward on the card); ``batch_mask``
multiplies their per-pixel outputs before the sums, with the denominators of
the JAX losses. Label smoothing is a case the JAX kernel does not take
either, so it uses the plain per-pixel CE below: a dispatch on the config,
not a fallback on failure.

Masks are applied as selects (``torch.where``), as XLA compiles the JAX
losses' products with 0/1 masks: an ignored pixel never passes a NaN (focal's
(1-pt)^(gamma-1) at pt = 1 when gamma < 1) into its gradient.

On a data axis of several ranks (``data_axis``), each rank holds its slice
of the global batch and the loss is the global batch's: every denominator
(CE's Σw, focal's pixel count, dice's sample count) is summed over the
ranks, and a rank's loss is its own numerator over that global denominator,
so the ranks' losses (and their gradients) sum to the one-process loss.

The MAE pretraining loss (:func:`mae_reconstruction_loss`) is plain torch.
"""

from __future__ import annotations

import typing

import torch
import torch.nn.functional as F

from s2tpu_torch.ops.fused_ce import fused_ce_per_pixel
from s2tpu_torch.parallel.mesh import SINGLE, DataAxis


def _one_hot_smoothed(labels: torch.Tensor, num_classes: int, label_smoothing: float) -> torch.Tensor:
    oh = F.one_hot(labels.long(), num_classes).to(torch.float32)
    if label_smoothing > 0.0:
        oh = oh * (1.0 - label_smoothing) + label_smoothing / num_classes
    return oh


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0) -> torch.Tensor:
    """Unreduced CE over channel-last logits; (..., K) x (...) -> (...)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    target = _one_hot_smoothed(labels, logits.shape[-1], label_smoothing)
    return -(target * logp).sum(dim=-1)


def _valid_mask(labels: torch.Tensor, ignore_index: int | None, batch_mask: torch.Tensor | None) -> torch.Tensor:
    """Per-pixel bool mask: not the ignore index, and in a real (unpadded) row."""
    valid = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    if ignore_index is not None:
        valid = valid & (labels != ignore_index)
    if batch_mask is not None:
        valid = valid & batch_mask.reshape((-1,) + (1,) * (labels.ndim - 1)).bool()
    return valid


def _pixel_mask(labels: torch.Tensor, batch_mask: torch.Tensor) -> torch.Tensor:
    """``batch_mask`` (B,) broadcast to every pixel, flattened like the kernels' outputs."""
    shape = (-1,) + (1,) * (labels.ndim - 1)
    return batch_mask.to(torch.float32).reshape(shape).expand(labels.shape).reshape(-1)


def _labels_int32(labels: torch.Tensor) -> torch.Tensor:
    return labels if labels.dtype == torch.int32 else labels.to(torch.int32)


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor | None = None,
    ignore_index: int | None = None,
    label_smoothing: float = 0.0,
    batch_mask: torch.Tensor | None = None,
    data_axis: DataAxis = SINGLE,
) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss-equivalent weighted masked mean
    (``s2tpu/train/losses.py:55-70``), over the global batch of ``data_axis``."""
    if label_smoothing == 0.0:
        k = logits.shape[-1]
        cw = class_weights if class_weights is not None else torch.ones(k, dtype=torch.float32, device=logits.device)
        loss, weight = fused_ce_per_pixel(logits, _labels_int32(labels), cw, ignore_index, None)
        if batch_mask is not None:
            m = _pixel_mask(labels, batch_mask)
            loss, weight = loss * m, weight * m
        return loss.sum() / data_axis.total(weight.sum()).clamp_min(1e-12)
    ce = _per_pixel_ce(logits, labels, label_smoothing)
    valid = _valid_mask(labels, ignore_index, batch_mask)
    w = class_weights.to(torch.float32)[labels.long()] if class_weights is not None else torch.ones_like(ce)
    w = torch.where(valid, w, 0.0)
    return (ce * w).sum() / data_axis.total(w.sum()).clamp_min(1e-12)


def focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    alpha: torch.Tensor,
    gamma: float,
    ignore_index: int | None = None,
    label_smoothing: float = 0.0,
    batch_mask: torch.Tensor | None = None,
    data_axis: DataAxis = SINGLE,
) -> torch.Tensor:
    """alpha_y (1-pt)^gamma ce, mean over ALL pixels (``s2tpu/train/losses.py:73-94``);
    with ``batch_mask``, over the pixels of the real rows; over the global
    batch of ``data_axis``."""
    if batch_mask is not None:
        denom = (data_axis.total(batch_mask.to(torch.float32).sum()) * labels[0].numel()).clamp_min(1e-12)
    else:
        denom = data_axis.total(labels.numel())
    if label_smoothing == 0.0:
        loss, _ = fused_ce_per_pixel(logits, _labels_int32(labels), alpha, ignore_index, gamma)
        if batch_mask is not None:
            loss = loss * _pixel_mask(labels, batch_mask)
        return loss.sum() / denom
    ce = _per_pixel_ce(logits, labels, label_smoothing)
    ce = torch.where(_valid_mask(labels, ignore_index, batch_mask), ce, 0.0)
    pt = torch.exp(-ce)
    focal = alpha.to(torch.float32)[labels.long()] * (1.0 - pt) ** gamma * ce
    return focal.sum() / denom


def dice_loss(
    logits: torch.Tensor, labels: torch.Tensor, eps: float = 1e-8, batch_mask: torch.Tensor | None = None,
    data_axis: DataAxis = SINGLE,
) -> torch.Tensor:
    """Multiclass soft-dice: 1 - mean per-sample dice coefficient (``:104-122``),
    over the global batch of ``data_axis``."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    target = F.one_hot(labels.long(), num_classes).to(torch.float32)
    dims = tuple(range(1, probs.ndim))
    intersection = (probs * target).sum(dims)
    union = (probs + target).sum(dims)
    per_sample = 1.0 - (2.0 * intersection + eps) / (union + eps)
    if batch_mask is not None:
        m = batch_mask.to(torch.float32)
        return (per_sample * m).sum() / data_axis.total(m.sum()).clamp_min(1e-12)
    if data_axis.size == 1:
        return per_sample.mean()
    return per_sample.sum() / data_axis.total(per_sample.numel())


class LossOutput(typing.NamedTuple):
    total: torch.Tensor
    components: dict[str, torch.Tensor]


LossFn = typing.Callable[..., LossOutput]


def class_weights_from_distribution(
    class_distribution: typing.Sequence[float], num_classes: int, masked_loss: bool
) -> torch.Tensor:
    """``w_c = 1 - p_c`` for real classes; the masked background keeps its raw
    distribution value (``s2tpu/train/losses.py:147-157``)."""
    cw = torch.as_tensor(class_distribution, dtype=torch.float32)
    skip = int(masked_loss)
    weights = torch.cat([cw[:skip], 1.0 - cw[skip:]])
    if weights.shape[0] != num_classes:
        raise ValueError(f"class_distribution has {weights.shape[0]} classes, the model {num_classes}")
    return weights


def make_loss_fn(
    loss_type: str,
    num_classes: int,
    masked_loss: bool,
    weighted_loss: bool = False,
    class_distribution: typing.Sequence[float] | None = None,
    label_smoothing: float = 0.0,
    focal_gamma: float | None = 2.0,
    dice_eps: float | None = 1e-8,
    dice_weight: float | None = 0.5,
    focal_weight: float | None = 0.5,
    device: torch.device | str = "cpu",
    data_axis: DataAxis = SINGLE,
) -> LossFn:
    """Factory mirroring ``s2tpu/train/losses.py::make_loss_fn`` (``:133-182``);
    the class weights live on ``device``; the losses are the global batch's
    of ``data_axis``."""
    if loss_type not in ("ce", "focal", "dice", "dice_focal"):
        raise ValueError(f"Unknown loss type {loss_type!r}")
    ignore_index = 0 if masked_loss else None
    class_weights = None
    if weighted_loss:
        if class_distribution is None:
            raise ValueError("weighted_loss requires class_distribution")
        class_weights = class_weights_from_distribution(class_distribution, num_classes, masked_loss).to(device)
    alpha = class_weights if class_weights is not None else torch.ones(num_classes, dtype=torch.float32, device=device)

    def focal(logits: torch.Tensor, labels: torch.Tensor, batch_mask: torch.Tensor | None) -> torch.Tensor:
        return focal_loss(logits, labels, alpha, focal_gamma, ignore_index, label_smoothing, batch_mask, data_axis)

    def fn(logits: torch.Tensor, labels: torch.Tensor, batch_mask: torch.Tensor | None = None) -> LossOutput:
        if loss_type == "ce":
            return LossOutput(
                cross_entropy(logits, labels, class_weights, ignore_index, label_smoothing, batch_mask, data_axis), {}
            )
        if loss_type == "focal":
            return LossOutput(focal(logits, labels, batch_mask), {})
        if loss_type == "dice":
            return LossOutput(dice_loss(logits, labels, dice_eps, batch_mask, data_axis), {})
        d = dice_weight * dice_loss(logits, labels, dice_eps, batch_mask, data_axis)
        f = focal_weight * focal(logits, labels, batch_mask)
        return LossOutput(d + f, {"dice": d, "focal": f})

    return fn


def mae_reconstruction_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    norm_pix: bool = False,
    sample_weights: torch.Tensor | None = None,
    data_axis: DataAxis = SINGLE,
) -> torch.Tensor:
    """MAE loss (``s2tpu/train/losses.py:185-210``): the per-patch MSE in f32,
    averaged over the masked (removed) patches only.

    pred/target (B, L, D) patch pixels; mask (B, L) with 1 = masked;
    ``norm_pix`` standardizes each target patch (biased variance, eps 1e-6).
    ``sample_weights`` (B,) 0/1 drops rows (padded eval entries) from the
    numerator and the denominator alike. On a data axis the denominator is
    the global batch's masked patches, so this rank's value is its share of
    the global loss (the shares sum to it).
    """
    target, pred = target.float(), pred.float()
    if norm_pix:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, unbiased=False)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    per_patch = ((pred - target) ** 2).mean(dim=-1)
    mask = mask.float()
    if sample_weights is not None:
        mask = mask * sample_weights.float()[:, None]
    return (per_patch * mask).sum() / data_axis.total(mask.sum()).clamp_min(1e-12)
