"""The device-resident training corpus (the port of ``s2tpu/data/device_corpus.py:37-182``).

The whole corpus of int16 segments is uploaded to device memory once; per
step the host sends only three (B,) int32 vectors, the segment indices and
the crop offsets, and the crops are gathered on the device inside the train
step. The gather is plain PyTorch advanced indexing: no host sync and no
shape that depends on the data, so a CUDA graph captures it with the rest
of the step. A packed memmap corpus (``PackedSource``) is uploaded straight
from its memmap (``device_corpus.py:48-50``), in pieces through two pinned
staging buffers on the card; any other source is stacked segment by
segment first.

The sharded corpus (the segment axis split over a data mesh,
``device_corpus.py:184-309``) needs a data axis above one rank, which the
port does not have, and is refused by the trainers.
"""

from __future__ import annotations

import numpy as np
import torch

from s2tpu_torch.data.dataset import PackedSource, SegmentSource

UPLOAD_PIECE_BYTES = 64 << 20  # one pinned staging buffer of the memmap upload


def crop_slice_images(
    images: torch.Tensor, idx: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, crop: int
) -> torch.Tensor:
    """(N, H, W, C) or, multi-temporal, (N, T, H, W, C) corpus -> the (B[, T],
    crop, crop, C) crops at segments ``idx`` and offsets (``ys``, ``xs``),
    every frame of a sample cropped at the same place (the JAX
    ``crop_slice_images`` under ``vmap``)."""
    r = torch.arange(crop, device=images.device)
    rows = ys.long()[:, None] + r  # (B, crop)
    cols = xs.long()[:, None] + r
    i = idx.long()
    if images.dim() == 5:
        t = torch.arange(images.shape[1], device=images.device)
        return images[i[:, None, None, None], t[None, :, None, None], rows[:, None, :, None], cols[:, None, None, :]]
    return images[i[:, None, None], rows[:, :, None], cols[:, None, :]]


def _materialize(source: SegmentSource) -> tuple[np.ndarray, np.ndarray]:
    """The int16 images and uint8 labels of every segment of ``source``: a
    packed corpus's read-only memmaps as they are, else stacked segment by
    segment (the JAX ``_materialize``)."""
    if isinstance(source, PackedSource):
        return source.images, source.labels
    first = source[0]
    n = len(source)
    images = np.empty((n, *first.x.shape), np.int16)
    labels = np.empty((n, *first.y.shape), np.uint8)
    for i in range(n):
        s = source[i]
        images[i] = s.x
        labels[i] = s.y
    return images, labels


class DeviceCorpus:
    """Every segment of ``source`` uploaded once to ``device``, with the crop
    gather on the device.

    The labels stay uint8 on the device (the JAX package keeps int32,
    ``:139``) and widen to int32 in the gather: the crops are the same and
    the labels take a quarter of the memory. ``with_labels=False`` skips
    their upload (the MAE corpus)."""

    def __init__(self, source: SegmentSource, device: torch.device | str, with_labels: bool = True) -> None:
        images, labels = _materialize(source)
        # (N, H, W, C) single-frame or (N, T, H, W, C) multi-temporal: the
        # spatial axes are always the two before the channels.
        self.hw = images.shape[-3:-1]
        if isinstance(source, PackedSource):
            self.images = upload(images, device)
            self.labels = upload(labels, device) if with_labels else None
        else:
            self.images = torch.from_numpy(images).to(device)
            self.labels = torch.from_numpy(labels).to(device) if with_labels else None

    def gather(
        self, idx: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, crop: int
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(B,) device indices and offsets -> (B[, T], crop, crop, C) int16
        images and (B, crop, crop) int32 labels (None without labels)."""
        images = crop_slice_images(self.images, idx, ys, xs, crop)
        if self.labels is None:
            return images, None
        r = torch.arange(crop, device=self.labels.device)
        rows, cols = ys.long()[:, None] + r, xs.long()[:, None] + r
        return images, self.labels[idx.long()[:, None, None], rows[:, :, None], cols[:, None, :]].to(torch.int32)


def upload(array: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """A copy of ``array`` on ``device``, never a view of it (a packed
    corpus's read-only memmap stays untouched). To the card it goes in
    pieces of about ``UPLOAD_PIECE_BYTES`` along the first axis through two
    pinned staging buffers: the host fills one while the card copies the
    other."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.from_numpy(np.array(array))
    out = torch.empty(array.shape, dtype=torch.from_numpy(np.empty(0, array.dtype)).dtype, device=device)
    if out.numel() == 0:
        return out
    rows = max(1, UPLOAD_PIECE_BYTES // max(array[0].nbytes, 1))
    stages = [torch.empty((min(rows, len(array)), *array.shape[1:]), dtype=out.dtype, pin_memory=True)
              for _ in range(2)]
    done: list[torch.cuda.Event | None] = [None, None]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream()
        for k, start in enumerate(range(0, len(array), rows)):
            stage, j = stages[k % 2], k % 2
            if done[j] is not None:
                done[j].synchronize()  # the card has finished reading this buffer
            m = min(rows, len(array) - start)
            np.copyto(stage[:m].numpy(), array[start:start + m])
            out[start:start + m].copy_(stage[:m], non_blocking=True)
            done[j] = torch.cuda.Event()
            done[j].record(stream)
        stream.synchronize()
    return out


def sample_crop_batch(
    rng: np.random.Generator,
    order: np.ndarray,
    step: int,
    batch_size: int,
    hw: tuple[int, int],
    crop: int,
    random_crop: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host's draws for one step: the step's segment indices from
    ``order`` and its crop offsets, three (B,) int32 vectors; random offsets
    draw rows then columns from ``rng`` (``:164-181``), center offsets draw
    nothing."""
    idx = order[step * batch_size : (step + 1) * batch_size].astype(np.int32)
    if random_crop:
        ys = rng.integers(0, hw[0] - crop + 1, size=batch_size).astype(np.int32)
        xs = rng.integers(0, hw[1] - crop + 1, size=batch_size).astype(np.int32)
    else:
        ys = np.full(batch_size, (hw[0] - crop) // 2, np.int32)
        xs = np.full(batch_size, (hw[1] - crop) // 2, np.int32)
    return idx, ys, xs
