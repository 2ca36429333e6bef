"""JAX EfficientNet-UNet, Prithvi MAE and Prithvi segmentation weights -> the port's state dicts.

The port's own copy of the export mapping in
``s2tpu/checkpoint/convert_torch.py`` (``export_reference_unet_state_dict``,
``export_prithvi_state_dict``, ``export_reference_prithvi_seg_state_dict``
and their helpers). The port's module names are the reference PyTorch
models' state-dict names, so the results load into ``s2tpu_torch.models``
with ``strict=True``. Inputs are the Flax ``params`` and ``batch_stats``
trees as nested dicts of numpy arrays; every mapping is a pure transpose,
so values are bit-exact.

Layouts: Dense kernel (I, O) -> 1x1 conv (O, I, 1, 1); conv kernel
(kh, kw, I, O) -> (O, I, kh, kw); depthwise (k, k, 1, C) -> (C, 1, k, k);
ConvTranspose (kh, kw, I, O), which flax applies spatially mirrored, ->
un-mirrored torch (I, O, kh, kw); BatchNorm scale/bias + mean/var ->
weight/bias + running_mean/running_var.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

PRITHVI_WEIGHTS_FILE = "Prithvi_100M.pt"


def _f32(x) -> np.ndarray:
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype != np.float32 else a


def _conv(kernel) -> np.ndarray:
    return _f32(kernel).transpose(3, 2, 0, 1)  # (kh, kw, I, O) -> (O, I, kh, kw)


def _dense_to_conv1x1(kernel) -> np.ndarray:
    return np.ascontiguousarray(_f32(kernel).T)[:, :, None, None]  # (I, O) -> (O, I, 1, 1)


def _convtrans(p: dict, out: dict, prefix: str) -> None:
    k = _f32(p["kernel"])[::-1, ::-1]  # un-mirror flax's transpose-conv kernel
    out[f"{prefix}.weight"] = np.ascontiguousarray(k.transpose(2, 3, 0, 1))  # -> (I, O, kh, kw)
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _bn(p: dict, s: dict, out: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])
    out[f"{prefix}.running_mean"] = _f32(s["mean"])
    out[f"{prefix}.running_var"] = _f32(s["var"])
    out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _conv_with_bias(p: dict, out: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = _conv(p["kernel"])
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _double_conv(p: dict, s: dict, out: dict, prefix: str) -> None:
    _conv_with_bias(p["conv0"], out, f"{prefix}.0")
    _bn(p["bn0"], s["bn0"], out, f"{prefix}.1")
    _conv_with_bias(p["conv1"], out, f"{prefix}.3")
    _bn(p["bn1"], s["bn1"], out, f"{prefix}.4")


def unet_state_dict_from_jax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """Flax EfficientNetUNet (params, batch_stats) -> the port's state dict."""
    enc_p, enc_s = params["encoder"], batch_stats["encoder"]
    out: dict[str, np.ndarray] = {"encoder.stem.0.weight": _conv(enc_p["stem_conv"]["kernel"])}
    _bn(enc_p["stem_bn"], enc_s["stem_bn"], out, "encoder.stem.1")
    n_blocks = sum(1 for k in enc_p if k.startswith("block_"))
    for i in range(n_blocks):
        p, s, pre = enc_p[f"block_{i}"], enc_s[f"block_{i}"], f"encoder.blocks.{i}"
        if "expand_conv" in p:
            out[f"{pre}.stem.0.weight"] = _dense_to_conv1x1(p["expand_conv"]["kernel"])
            _bn(p["expand_bn"], s["expand_bn"], out, f"{pre}.stem.1")
            out[f"{pre}.stem.3.weight"] = _conv(p["depthwise_conv"]["kernel"])
            _bn(p["depthwise_bn"], s["depthwise_bn"], out, f"{pre}.stem.4")
        else:
            out[f"{pre}.stem.0.weight"] = _conv(p["depthwise_conv"]["kernel"])
            _bn(p["depthwise_bn"], s["depthwise_bn"], out, f"{pre}.stem.1")
        if "se_reduce" in p:
            for ours, theirs in (("se_reduce", 1), ("se_expand", 3)):
                out[f"{pre}.squeeze_excitation.{theirs}.weight"] = _dense_to_conv1x1(p[ours]["kernel"])
                out[f"{pre}.squeeze_excitation.{theirs}.bias"] = _f32(p[ours]["bias"])
        out[f"{pre}.final_layer.0.weight"] = _dense_to_conv1x1(p["project_conv"]["kernel"])
        _bn(p["project_bn"], s["project_bn"], out, f"{pre}.final_layer.1")
    out["encoder.conv_head.0.weight"] = _dense_to_conv1x1(enc_p["head_conv"]["kernel"])
    _bn(enc_p["head_bn"], enc_s["head_bn"], out, "encoder.conv_head.1")

    n_up = sum(1 for k in params if k.startswith("up_conv"))
    for i in range(n_up):
        _convtrans(params[f"up_conv{i}"], out, f"up_convs.{i}")
        _double_conv(params[f"double_conv{i}"], batch_stats[f"double_conv{i}"], out, f"double_convs.{i}")
    if "input_up_conv" in params:
        _convtrans(params["input_up_conv"], out, "input_up_conv")
        _double_conv(params["input_double_conv"], batch_stats["input_double_conv"], out, "input_double_conv")
    out["out_conv1x1.weight"] = _dense_to_conv1x1(params["classifier"]["kernel"])
    out["out_conv1x1.bias"] = _f32(params["classifier"]["bias"])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}  # owned, contiguous copies


# ---------------------------------------------------------------------------
# Prithvi MAE
# ---------------------------------------------------------------------------
def _linear(p: dict, out: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(_f32(p["kernel"]).T)  # (I, O) -> (O, I)
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _layernorm(p: dict, out: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _vit_block(p: dict, out: dict, prefix: str) -> None:
    _layernorm(p["norm1"], out, f"{prefix}.norm1")
    _layernorm(p["norm2"], out, f"{prefix}.norm2")
    _linear(p["attn"]["qkv"], out, f"{prefix}.attn.qkv")
    _linear(p["attn"]["proj"], out, f"{prefix}.attn.proj")
    _linear(p["mlp_fc1"], out, f"{prefix}.mlp.fc1")
    _linear(p["mlp_fc2"], out, f"{prefix}.mlp.fc2")


def _prithvi_encoder(params: dict, cfg, out: dict, prefix: str = "") -> None:
    """The encoder's keys (cls token, patch projection as the Conv3d weight,
    regenerated ``pos_embed``, final norm, blocks) under ``prefix``."""
    from s2tpu_torch.models.prithvi_mae import sincos_3d

    out[f"{prefix}cls_token"] = _f32(params["cls_token"])
    k = _f32(params["patch_proj"]["kernel"])
    w = k.reshape(cfg.tubelet_size, cfg.patch_size, cfg.patch_size, cfg.in_chans, k.shape[1])
    out[f"{prefix}patch_embed.proj.weight"] = np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))
    out[f"{prefix}patch_embed.proj.bias"] = _f32(params["patch_proj"]["bias"])
    out[f"{prefix}pos_embed"] = sincos_3d(cfg.embed_dim, cfg.grid_size, cls_token=True)[None]
    _layernorm(params["encoder_norm"], out, f"{prefix}norm")
    for i in range(sum(1 for key in params if key.startswith("block_"))):
        _vit_block(params[f"block_{i}"], out, f"{prefix}blocks.{i}")


def prithvi_state_dict_from_jax(params: dict, config) -> dict[str, torch.Tensor]:
    """Flax ``PrithviMAE`` params (nested dicts of numpy arrays) -> the
    published ``Prithvi_100M.pt`` layout, which the port's ``PrithviMAE``
    loads with ``strict=True``.

    The port's copy of ``export_prithvi_state_dict`` and its helpers
    (``s2tpu/checkpoint/convert_torch.py:402-445``, ``:500-557``): dense
    kernels transpose, the patch projection (tub·p·q·C, D) becomes the
    Conv3d weight (D, C, tub, p, q), and the fixed sincos tables are
    regenerated into ``pos_embed`` / ``decoder_pos_embed`` as the published
    checkpoint carries them. ``config`` is the port's ``PrithviConfig`` (or
    any object with the same geometry fields).
    """
    from s2tpu_torch.models.prithvi_mae import sincos_3d

    cfg = config
    out: dict[str, np.ndarray] = {}
    _prithvi_encoder(params, cfg, out)
    if "decoder_embed" in params:
        _linear(params["decoder_embed"], out, "decoder_embed")
        out["mask_token"] = _f32(params["mask_token"])
        out["decoder_pos_embed"] = sincos_3d(cfg.decoder_embed_dim, cfg.grid_size, cls_token=True)[None]
        _layernorm(params["decoder_norm"], out, "decoder_norm")
        _linear(params["decoder_pred"], out, "decoder_pred")
        for i in range(sum(1 for key in params if key.startswith("decoder_block_"))):
            _vit_block(params[f"decoder_block_{i}"], out, f"decoder_blocks.{i}")
    return {key: torch.from_numpy(np.array(v)) for key, v in out.items()}


def prithvi_seg_state_dict_from_jax(params: dict, batch_stats: dict, backbone_config) -> dict[str, torch.Tensor]:
    """Flax ``PrithviSegmentationNet`` (params, batch_stats) -> the reference
    ``PrithviSegmentationNet.state_dict()`` naming, which the port's
    ``PrithviSegmentationNet`` loads with ``strict=True``.

    The port's copy of ``export_reference_prithvi_seg_state_dict``
    (``s2tpu/checkpoint/convert_torch.py:560-585``): the encoder-only
    backbone with its regenerated ``backbone.pos_embed`` (``backbone_config``
    gives the geometry), the neck's transpose convs un-mirrored (flax applies
    them spatially flipped: a conversion without the flip loads but computes
    something else), its LayerNorms, and the head's conv/BatchNorm pairs and
    classifier.
    """
    out: dict[str, np.ndarray] = {}
    _prithvi_encoder(params["backbone"], backbone_config, out, prefix="backbone.")
    for ours, theirs in (("up0", 0), ("up1", 3), ("up2", 4), ("up3", 7)):
        _convtrans(params["neck"][ours], out, f"neck.feature_pyramid_net.{theirs}")
    for ours, theirs in (("ln0", 1), ("ln1", 5)):
        _layernorm(params["neck"][ours], out, f"neck.feature_pyramid_net.{theirs}.ln")
    head, head_stats = params["head"], batch_stats["head"]
    n_convs = sum(1 for k in head if k.startswith("conv"))
    for i in range(n_convs):
        _conv_with_bias(head[f"conv{i}"], out, f"head.net.{3 * i}")
        _bn(head[f"bn{i}"], head_stats[f"bn{i}"], out, f"head.net.{3 * i + 1}")
    _conv_with_bias(head["classifier"], out, f"head.net.{3 * n_convs + 1}")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def encoder_state_dict(state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A Prithvi MAE state dict in the published layout without its decoder
    keys (``decoder_*``, ``mask_token``): what an encoder-only
    ``PrithviMAE(decoder=False)`` loads."""
    return {k: v for k, v in state_dict.items() if not (k.startswith("decoder") or k == "mask_token")}


def load_prithvi_weights(
    model: torch.nn.Module, path: str | Path | None = None, include_decoder: bool = True
) -> None:
    """Load a state dict in the published ``Prithvi_100M.pt`` layout into a
    port ``PrithviMAE`` (default path: ``weights/Prithvi_100M.pt``) with
    ``strict=True``; ``include_decoder=False`` drops the decoder keys first,
    for an encoder-only model (the JAX package's
    ``load_prithvi_weights(..., include_decoder=False)``). Raises
    FileNotFoundError when the file is absent; position tables of another
    grid are ignored by the model's loader."""
    from s2tpu_torch.configs.paths import WEIGHTS_DIR

    path = Path(path) if path is not None else WEIGHTS_DIR / PRITHVI_WEIGHTS_FILE
    if not path.exists():
        raise FileNotFoundError(str(path))
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if not include_decoder:
        state_dict = encoder_state_dict(state_dict)
    model.load_state_dict(state_dict, strict=True)
