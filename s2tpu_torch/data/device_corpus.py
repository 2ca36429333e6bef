"""The device-resident training corpus (the port of ``s2tpu/data/device_corpus.py``).

The whole corpus of int16 segments is uploaded to device memory once; per
step the host sends only three (B,) int32 vectors, the segment indices and
the crop offsets, and the crops are gathered on the device inside the train
step. The gather is plain PyTorch advanced indexing: no host sync and no
shape that depends on the data, so a CUDA graph captures it with the rest
of the step. A packed memmap corpus (``PackedSource``) is uploaded straight
from its memmap (``device_corpus.py:48-50``), in pieces through two pinned
staging buffers on the card; any other source is stacked segment by
segment first.

The sharded corpus (``device_corpus.py:76-140``, ``:184-309``): on a data
axis of D > 1 ranks (``DeviceCorpus(..., data=DataAxis)``) the segment axis
is padded at its end to a multiple of D by wrap-around duplicates, and data
rank r uploads only its block, segments [r·n_local, (r+1)·n_local) of the
padded corpus (a packed corpus is read from that slice of its memmap only).
In the port every rank is one process, so the JAX check that the data axis
is process-ordered becomes: data index r owns block r. The ranks of one
'model' group share their data index and upload the same block. Every rank
draws the same global orders from the epoch's generator, one per block
(:func:`sharded_epoch_orders`), and each step's device-major draws
(:func:`sample_sharded_crop_batch`); rank r takes its rows of them, whose
ids are local to its block, and gathers with :meth:`DeviceCorpus.gather`
(the JAX ``sharded_gather`` / ``sharded_image_gather``: no cross-rank
traffic, so the gather stays inside a graphed step).
"""

from __future__ import annotations

import numpy as np
import torch

from s2tpu_torch import profiling
from s2tpu_torch.data.dataset import PackedSource, SegmentSource
from s2tpu_torch.parallel.mesh import DataAxis

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


def _materialize(source: SegmentSource, ids: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The int16 images and uint8 labels of the segments ``ids`` of
    ``source`` (all of them by default): a packed corpus's read-only memmaps
    as they are (a contiguous run of ids as a slice of them), else stacked
    segment by segment (the JAX ``_materialize``)."""
    if isinstance(source, PackedSource):
        if ids is None:
            return source.images, source.labels
        if len(ids) and np.array_equal(ids, np.arange(ids[0], ids[0] + len(ids))):
            return source.images[ids[0]:ids[0] + len(ids)], source.labels[ids[0]:ids[0] + len(ids)]
        return source.images[ids], source.labels[ids]
    ids = np.arange(len(source)) if ids is None else ids
    first = source[int(ids[0])]
    images = np.empty((len(ids), *first.x.shape), np.int16)
    labels = np.empty((len(ids), *first.y.shape), np.uint8)
    for k, i in enumerate(ids):
        s = source[int(i)]
        images[k] = s.x
        labels[k] = s.y
    return images, labels


def block_ids(n: int, size: int, index: int) -> np.ndarray:
    """The global segment ids of data rank ``index``'s block of a corpus of
    ``n`` segments sharded over ``size`` ranks: [index·n_local,
    (index+1)·n_local) of the corpus padded at its end to size·n_local by
    wrap-around duplicates (id n + j is segment j)."""
    n_local = -(-n // size)
    return np.arange(index * n_local, (index + 1) * n_local) % n


class DeviceCorpus:
    """Every segment of ``source`` uploaded once to ``device``, with the crop
    gather on the device.

    The labels stay uint8 on the device (the JAX package keeps int32,
    ``:139``) and widen to int32 in the gather: the crops are the same and
    the labels take a quarter of the memory. ``with_labels=False`` skips
    their upload (the MAE corpus). With ``data``, a data axis of more than
    one rank, the corpus is sharded (:attr:`sharded`): this rank uploads
    only its block of :attr:`n_local` segments (:func:`block_ids`), and the
    gather takes ids local to the block."""

    def __init__(self, source: SegmentSource, device: torch.device | str, with_labels: bool = True,
                 data: DataAxis | None = None) -> None:
        self.n = len(source)
        self.sharded = data is not None and data.size > 1
        self.size = data.size if self.sharded else 1
        self.n_local = -(-self.n // self.size)
        with profiling.span("s2tpu.data.corpus"):
            with profiling.span("s2tpu.data.materialize"):
                ids = block_ids(self.n, self.size, data.index) if self.sharded else None
                images, labels = _materialize(source, ids)
            # (N, H, W, C) single-frame or (N, T, H, W, C) multi-temporal: the
            # spatial axes are always the two before the channels.
            self.hw = images.shape[-3:-1]
            with profiling.span("s2tpu.data.upload"):
                if isinstance(source, PackedSource):
                    self.images = upload(images, device)
                    self.labels = upload(labels, device) if with_labels else None
                else:
                    self.images = torch.from_numpy(images).to(device)
                    self.labels = torch.from_numpy(labels).to(device) if with_labels else None

    def shard_pools(self, train_idx: np.ndarray) -> list[np.ndarray]:
        """The global train ids by owning block, as ids local to it: block k
        owns segments [k·n_local, (k+1)·n_local)."""
        assert self.sharded
        owners = train_idx // self.n_local
        return [train_idx[owners == k] % self.n_local for k in range(self.size)]

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


def sharded_epoch_orders(
    rng: np.random.Generator,
    pools: list[np.ndarray],
    per_shard_bs: int,
    overfit_batches: int,
    weights: list[np.ndarray] | None = None,
) -> tuple[list[np.ndarray], int]:
    """Each block's order of local ids for the epoch, and its step count
    (``:184-240``): every block gives ``per_shard_bs`` samples a step.
    Unweighted: each pool shuffled without replacement, the epoch ending when
    the smallest runs dry (drop-last). Weighted (``weights`` aligned with
    ``pools``): draws with replacement at probabilities normalized per
    block, exact global weighted sampling only when the blocks' masses are
    equal, one pass worth of draws. Raises on a pool too small to fill a
    block's batch, and on an empty pool when overfitting."""
    sizes = [len(p) for p in pools]
    if min(sizes) < per_shard_bs and overfit_batches == 0:
        raise ValueError(
            f"sharded device_corpus: smallest shard train pool has {min(sizes)} samples "
            f"(< per-shard batch {per_shard_bs}; pool sizes {sizes}): the epoch would "
            "train zero steps. Use a smaller batch size, more data, or a non-sharded corpus."
        )
    if overfit_batches > 0 and min(sizes) == 0:
        raise ValueError(
            f"sharded device_corpus: an overfit shard pool is empty (pool sizes {sizes}); "
            "overfitting needs at least one sample per shard: use a non-sharded corpus."
        )
    if weights is not None:
        n_batches = sum(sizes) // (per_shard_bs * len(pools))
        if overfit_batches > 0:
            n_batches = min(overfit_batches, max(n_batches, 1))
        draws = n_batches * per_shard_bs
        orders = [rng.choice(p, size=draws, replace=True, p=w / w.sum()) for p, w in zip(pools, weights)]
        return orders, n_batches
    orders = [rng.permutation(p) for p in pools]
    n_batches = min(len(o) for o in orders) // per_shard_bs
    if overfit_batches > 0:
        n_batches = min(overfit_batches, max(n_batches, 1))
        orders = [np.concatenate([o] * (per_shard_bs * n_batches // max(len(o), 1) + 1)) for o in orders]
    return orders, n_batches


def sample_sharded_crop_batch(
    rng: np.random.Generator,
    orders: list[np.ndarray],
    step: int,
    per_shard_bs: int,
    hw: tuple[int, int],
    crop: int,
    random_crop: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One step's device-major (B,) local ids and crop offsets
    (``:243-268``): entries [k·per_shard_bs, (k+1)·per_shard_bs) belong to
    data rank k and index its block."""
    idx = np.concatenate([o[step * per_shard_bs : (step + 1) * per_shard_bs] for o in orders]).astype(np.int32)
    b = len(idx)
    if random_crop:
        ys = rng.integers(0, hw[0] - crop + 1, size=b).astype(np.int32)
        xs = rng.integers(0, hw[1] - crop + 1, size=b).astype(np.int32)
    else:
        ys = np.full(b, (hw[0] - crop) // 2, np.int32)
        xs = np.full(b, (hw[1] - crop) // 2, np.int32)
    return idx, ys, xs
