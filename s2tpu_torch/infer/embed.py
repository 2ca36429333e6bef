"""MAE encoder embeddings (the port of ``s2tpu/infer/embed.py``): the serving product of a Prithvi MAE pretrain.

The reference consumes a pretrained MAE only through
``PrithviSegmentationNet``'s ``forward_encoder(x, mask_ratio=0.0)``; this
module exports those encoder tokens standalone, as per-segment feature
vectors for linear probes, clustering or retrieval. The encoder is built
alone (``PrithviMAE(decoder=False)``), so no decoder weights reach the card;
its attention takes the model's route (the fused kernel #8 up to the fused
budget, the streaming kernel #5 beyond it), forward only. The position
tables are fixed sincos tables of the configured grid, so any crop that is
a multiple of the patch size works with the same weights.
:func:`calibrate_encoder_int8` quantizes the layers the encoder forward
touches (``infer/quantize.py``), and :func:`make_embed_fn` with its
``qstate`` runs them int8.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from s2tpu_torch.data.augment import normalize
from s2tpu_torch.models.prithvi_mae import PrithviConfig, PrithviMAE

POOLS = ("mean", "cls", "tokens")


def load_encoder(
    state_dict: dict[str, torch.Tensor], model_config: PrithviConfig, dtype: torch.dtype,
    device: torch.device | str,
) -> PrithviMAE:
    """An encoder-only ``PrithviMAE`` on ``device`` holding the encoder of a
    published-layout MAE state dict (decoder keys dropped, ``strict=True``)."""
    from s2tpu_torch.checkpoint.convert import encoder_state_dict

    model = PrithviMAE(model_config, dtype=dtype, decoder=False)
    model.load_state_dict(encoder_state_dict(state_dict), strict=True)
    return model.to(device).eval()


def make_embed_fn(
    model: PrithviMAE, mean, std, pool: str = "mean", qstate: dict | None = None
) -> typing.Callable[[np.ndarray | torch.Tensor], torch.Tensor]:
    """``raw images -> embeddings`` on the model's device, with no autograd.

    Input: raw-DN images, (B, H, W, C) or (B, T, H, W, C). Preprocessing is
    the MAE trainer's eval path (f32 ``(x - mean) / std``, cast to the
    model's compute dtype). Output: (B, D) for pool 'mean' (the average of
    the patch tokens) or 'cls' (the class token), (B, 1 + L, D) for
    'tokens'; in the compute dtype. With ``qstate`` (from
    :func:`calibrate_encoder_int8`) the calibrated layers of a copy of the
    model run int8 (``s2tpu/infer/embed.py:40-76``).
    """
    if pool not in POOLS:
        raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
    device = model.cls_token.device
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device)
    if qstate is not None:
        from s2tpu_torch.infer.quantize import quantized

        model, _ = quantized(model, qstate)

    @torch.no_grad()
    def embed(images: np.ndarray | torch.Tensor) -> torch.Tensor:
        x = normalize(torch.as_tensor(images).to(device), mean_t, std_t, dtype=model.dtype)
        x = x[:, None] if x.dim() == 4 else x
        tokens, _, _ = model.forward_encoder(x, 0.0)
        if pool == "cls":
            return tokens[:, 0]
        if pool == "mean":
            return tokens[:, 1:].mean(dim=1)
        return tokens

    return embed


def calibrate_encoder_int8(
    model: PrithviMAE, mean, std, batches: typing.Iterable[np.ndarray | torch.Tensor]
) -> dict[str, dict]:
    """int8 qstate for the encoder-only forward, the port of
    ``s2tpu/infer/embed.py:79-112``: activation max-abs recorded over the
    encoder forwards of ``batches`` (raw-DN images, the embedding
    preprocessing), weights quantized per output channel. Only layers the
    encoder forward touches are calibrated."""
    from s2tpu_torch.infer.quantize import ActivationRecorder, quantize_weights

    device = model.cls_token.device
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device)
    rec = ActivationRecorder()
    n = 0
    with torch.no_grad(), rec.recording(model):
        for images in batches:
            x = normalize(torch.as_tensor(images).to(device), mean_t, std_t, dtype=model.dtype)
            model.forward_encoder(x[:, None] if x.dim() == 4 else x, 0.0)
            rec.finish()
            n += 1
    if n == 0:
        raise ValueError("no calibration batches")
    return quantize_weights(model, rec.scales())


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Center crop on the trailing (H, W, C) axes of a (..., H, W, C) array."""
    h, w = img.shape[-3], img.shape[-2]
    if h < size or w < size:
        raise ValueError(f"segment {h}x{w} smaller than crop {size}")
    h0, w0 = (h - size) // 2, (w - size) // 2
    return img[..., h0 : h0 + size, w0 : w0 + size, :]
