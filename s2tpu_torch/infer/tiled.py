"""Tiled sliding-window inference with on-device stitching.

The port of ``s2tpu/infer/tiled.py``: tiles of ALL images form one flat work
queue consumed in ``batch_size`` chunks; each tile's logits are weighted by a
separable Hann window (with an ``eps=1e-2`` floor) and accumulated with its
weight into per-image sums on the device; the blend is
``acc / max(wsum, 1e-9)``, reduced by argmax to uint8 class maps. PyTorch
runs eagerly, so the last chunk is simply shorter (JAX pads it to one static
shape) and the stitching is plain tensor slice-adds.
"""

from __future__ import annotations

import numpy as np
import torch

from s2tpu_torch.infer.predict import Predictor


def tile_offsets(size: int, tile: int, stride: int) -> list[int]:
    """Start offsets covering [0, size) with the last tile flush to the edge."""
    if size <= tile:
        return [0]
    offs = list(range(0, size - tile + 1, stride))
    if offs[-1] != size - tile:
        offs.append(size - tile)
    return offs


def hann_window(tile: int, eps: float = 1e-2) -> np.ndarray:
    """Separable 2D Hann blending window (eps floor keeps borders covered)."""
    w = np.hanning(tile + 2)[1:-1].astype(np.float32) + eps
    return np.outer(w, w)


def tile_coords(n: int, h: int, w: int, tile: int, stride: int) -> list[tuple[int, int, int]]:
    """(image, y, x) of every tile of every image, in queue order."""
    ys, xs = tile_offsets(h, tile, stride), tile_offsets(w, tile, stride)
    return [(i, y, x) for i in range(n) for y in ys for x in xs]


def tiled_logits(
    predict: Predictor,
    images: torch.Tensor,
    tile: int,
    stride: int,
    num_classes: int,
    batch_size: int,
) -> torch.Tensor:
    """(N, H, W, C) or (N, T, H, W, C) rasters on the device -> (N, H, W, K) blended f32 logits.

    Multi-temporal stacks crop every frame at the same (y, x); ``predict``
    lays out T itself (folded into channels, or kept for the ViT).
    """
    n, h, w = images.shape[0], images.shape[-3], images.shape[-2]
    coords = tile_coords(n, h, w, tile, stride)
    window = torch.from_numpy(hann_window(tile)).to(images.device)[:, :, None]
    acc = torch.zeros((n, h, w, num_classes), dtype=torch.float32, device=images.device)
    wsum = torch.zeros((n, h, w, 1), dtype=torch.float32, device=images.device)
    for start in range(0, len(coords), batch_size):
        chunk = coords[start : start + batch_size]
        tiles = torch.stack([images[i, ..., y : y + tile, x : x + tile, :] for i, y, x in chunk])
        logits = predict(tiles).to(torch.float32)  # (B, tile, tile, K)
        for (i, y, x), lg in zip(chunk, logits):
            acc[i, y : y + tile, x : x + tile] += lg * window
            wsum[i, y : y + tile, x : x + tile] += window
    return acc / wsum.clamp_min(1e-9)


def tiled_predict_many(
    predict: Predictor,
    images: np.ndarray | torch.Tensor,
    num_classes: int,
    tile: int = 224,
    overlap: int = 32,
    batch_size: int = 8,
    return_logits: bool = False,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Batched tiled prediction over (N, H, W, C) or (N, T, H, W, C) raw-DN
    rasters -> ((N, H, W) uint8 class maps, (N, H, W, K) logits or None).

    The blended logits stay on the device unless ``return_logits``.
    """
    images = torch.as_tensor(images).to(predict.device)
    logits = tiled_logits(predict, images, tile, tile - overlap, num_classes, batch_size)
    class_maps = logits.argmax(dim=-1).to(torch.uint8).cpu().numpy()
    return class_maps, (logits.cpu().numpy() if return_logits else None)


def tiled_predict(
    predict: Predictor,
    image: np.ndarray | torch.Tensor,
    num_classes: int,
    tile: int = 224,
    overlap: int = 32,
    batch_size: int = 8,
    return_logits: bool = False,
) -> tuple[np.ndarray, np.ndarray | None]:
    """One (H, W, C) or (T, H, W, C) raster -> (class map, logits or None)."""
    class_maps, logits = tiled_predict_many(
        predict, torch.as_tensor(image)[None], num_classes, tile, overlap, batch_size, return_logits
    )
    return class_maps[0], (logits[0] if logits is not None else None)
