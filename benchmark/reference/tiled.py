"""Plain tiled prediction: the reference of the system's tiled serving.

Every segment is covered by tiles of ``tile``^2 at offsets ``0, stride,
2·stride, ...`` along each axis, with the last tile flush to the edge; each
tile's logits are weighted by a separable Hann window with a 1e-2 floor
(the window of ``tile + 2`` points without its two zero ends) and summed
with the weights into the segment's sums; the blend is the sum of weighted
logits over the sum of weights. The model runs on the tiles in blocks of
``block`` tiles, which changes nothing but the memory it takes.
"""

from __future__ import annotations

import typing

import numpy as np
import torch


def offsets(size: int, tile: int, stride: int) -> list[int]:
    if size <= tile:
        return [0]
    out = list(range(0, size - tile + 1, stride))
    if out[-1] != size - tile:
        out.append(size - tile)
    return out


def hann(tile: int, eps: float = 1e-2) -> np.ndarray:
    w = np.hanning(tile + 2)[1:-1].astype(np.float32) + eps
    return np.outer(w, w)


def tiles_per_segment(h: int, w: int, tile: int, stride: int) -> int:
    return len(offsets(h, tile, stride)) * len(offsets(w, tile, stride))


def blended_logits(logits_of: typing.Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor, tile: int,
                   stride: int, block: int = 8) -> torch.Tensor:
    """(N, H, W, C) raw tiles' source -> (N, H, W, K) blended float32 logits;
    ``logits_of`` maps (b, tile, tile, C) raw tiles to (b, tile, tile, K)."""
    n, h, w, _ = images.shape
    coords = [(i, y, x) for i in range(n) for y in offsets(h, tile, stride) for x in offsets(w, tile, stride)]
    window = torch.from_numpy(hann(tile)).to(images.device)
    acc = wsum = None
    for start in range(0, len(coords), block):
        part = coords[start:start + block]
        logits = logits_of(torch.stack([images[i, y:y + tile, x:x + tile] for i, y, x in part])).float()
        if acc is None:
            acc = torch.zeros((n, h, w, logits.shape[-1]), device=images.device)
            wsum = torch.zeros((n, h, w, 1), device=images.device)
        for (i, y, x), tile_logits in zip(part, logits):
            acc[i, y:y + tile, x:x + tile] += tile_logits * window[..., None]
            wsum[i, y:y + tile, x:x + tile] += window[..., None]
    return acc / wsum.clamp_min(1e-9)
