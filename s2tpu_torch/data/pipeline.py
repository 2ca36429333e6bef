"""Input pipeline: split wiring, host batching and device prefetch (the port of ``s2tpu/data/pipeline.py``).

    host thread:  GeoTIFF read -> random/center crop + flips (numpy slices)
    prefetch:     pinned host memory -> non-blocking copy to the device
    device:       normalize (in the trainer's step)

The same ``shuffle_seed`` gives the same split, epoch order, crops and
flips as the JAX package's Datamodule. Eval batches are padded to a fixed
batch size with a validity mask, as the JAX package pads them. A packed
memmap corpus (``PackedSource``) is gathered by the native multithreaded
crop gather (``s2tpu_torch.native``, flips applied during the copy), every
other source by numpy slices; both give the same batches, bit for bit.
Flips happen on the host when ``host_flips`` is on;
off, the stream draws none and the trainer flips on the device, taking the
same draws as the device corpus (``data/device_corpus.py``). The MAE
trainer takes these batches as they are (unlabeled sources give zero
labels): where the JAX MAE path flips on the host and again on the device,
the port flips once, which gives crops of the same distribution (the XOR of
two fair coins is a fair coin).

Under a data axis of several processes (:meth:`Datamodule.set_process`),
every process draws the same epoch order, crops and flips from the same
seed and gathers only its rows of each global batch
(``parallel.multihost.local_rows``: with gradient accumulation, its slice of
each global micro-batch); eval batches are padded to the global batch first,
then sliced, with their masks (``s2tpu/data/pipeline.py:196-240``).
"""

from __future__ import annotations

import queue
import threading
import typing

import numpy as np
import torch

from s2tpu_torch.configs.segmentation import DatamoduleConfig
from s2tpu_torch.data import statistics
from s2tpu_torch.data.dataset import PackedSource, SegmentSource, TiffSource, train_val_test_split
from s2tpu_torch.parallel.multihost import local_rows, local_slice


class HostBatch(typing.NamedTuple):
    images: np.ndarray  # (B, crop, crop, C) int16
    labels: np.ndarray  # (B, crop, crop) int32
    mask: np.ndarray  # (B,) bool; False entries are padding


class DeviceBatch(typing.NamedTuple):
    images: torch.Tensor  # (B, crop, crop, C) int16
    labels: torch.Tensor  # (B, crop, crop) int32
    mask: torch.Tensor  # (B,) bool


def epoch_rng(seed, epoch: int, overfit_batches: int) -> np.random.Generator:
    """Per-epoch generator; the overfit preset pins one seed across epochs so
    both sample order and crops are identical every epoch."""
    return np.random.default_rng(seed if overfit_batches > 0 else (seed, epoch))


def sample_epoch_order(
    rng: np.random.Generator,
    train_idx: np.ndarray,
    sample_weights: np.ndarray | None,
    batch_size: int,
    overfit_batches: int,
) -> tuple[np.ndarray, int]:
    """One epoch's sample order: shuffled, or weighted-with-replacement when
    per-sample weights exist; returns (order, number of drop-last batches)."""
    if sample_weights is not None:
        w = sample_weights[train_idx]
        order = rng.choice(train_idx, size=len(train_idx), replace=True, p=w / w.sum())
    else:
        order = rng.permutation(train_idx)
    n_batches = len(order) // batch_size
    if overfit_batches > 0:
        n_batches = min(overfit_batches, max(n_batches, 1))
        order = np.concatenate([order] * max(1, batch_size * n_batches // max(len(order), 1) + 1))
    return order, n_batches


class Datamodule:
    """Sources, splits, statistics and batch iterators for one config; one
    process's rows of each batch under :meth:`set_process`."""

    def __init__(self, cfg: DatamoduleConfig, source: SegmentSource | None = None) -> None:
        self.cfg = cfg
        self.n_proc, self.proc, self.micro_batches = 1, 0, 1
        ds = cfg.dataset_cfg
        self.source = (
            source if source is not None
            else TiffSource(ds.aoi, ds.label_map, ds.data_dir, n_time_frames=ds.n_time_frames)
        )
        self.train_idx, self.val_idx, self.test_idx = train_val_test_split(
            len(self.source), cfg.data_split, seed=cfg.shuffle_seed
        )
        self._mean_std: tuple[np.ndarray, np.ndarray] | None = None
        self._sample_weights: np.ndarray | None = None
        if cfg.class_distribution is not None:
            self._sample_weights = statistics.get_sample_weights(
                self.source, np.asarray(cfg.class_distribution), ignore_zero_label=True
            )

    # -- statistics ---------------------------------------------------------
    def mean_std(self) -> tuple[np.ndarray, np.ndarray]:
        if self._mean_std is None:
            stats = statistics.calculate_mean_std(self.source)
            self._mean_std = (np.asarray(stats["mean"], np.float32), np.asarray(stats["std"], np.float32))
        return self._mean_std

    def set_mean_std(self, mean: np.ndarray, std: np.ndarray) -> None:
        self._mean_std = (np.asarray(mean, np.float32), np.asarray(std, np.float32))

    def set_process(self, count: int, index: int, micro_batches: int = 1) -> None:
        """Feed process ``index`` of ``count`` (the data axis): its rows of
        each global train batch that trains as ``micro_batches``
        micro-batches, and its slice of each padded eval batch."""
        if self.cfg.batch_size % (count * micro_batches):
            raise ValueError(f"global batch {self.cfg.batch_size} does not split over {count} processes "
                             f"x {micro_batches} micro-batches")
        self.n_proc, self.proc, self.micro_batches = count, index, micro_batches

    def local_rows(self) -> np.ndarray | None:
        """This process's rows of a global train batch (None: all of them)."""
        if self.n_proc == 1:
            return None
        return local_rows(self.cfg.batch_size, self.micro_batches, self.n_proc, self.proc)

    # -- batching -----------------------------------------------------------
    def _sample_hw(self) -> tuple[int, int]:
        s = self.source[0]
        return s.x.shape[-3], s.x.shape[-2]

    def _gather_crops(
        self,
        indices: np.ndarray,
        ys: np.ndarray,
        xs: np.ndarray,
        flip_h: np.ndarray | None = None,
        flip_v: np.ndarray | None = None,
    ) -> HostBatch:
        crop = self.cfg.random_crop_size
        n = len(indices)
        if isinstance(self.source, PackedSource):
            # C++ row copies straight out of the memmap (s2tpu/data/pipeline.py:138-151)
            from s2tpu_torch import native

            gathered = native.gather_crops(
                self.source.images, self.source.labels, np.asarray(indices), ys, xs, crop,
                flip_h=flip_h, flip_v=flip_v,
            )
            if gathered is not None:
                return HostBatch(*gathered, np.ones(n, dtype=bool))
        first = self.source[int(indices[0])]
        c = first.x.shape[-1]
        lead = first.x.shape[:-3]  # multi-temporal samples are (T, H, W, C)
        images = np.empty((n, *lead, crop, crop, c), dtype=np.int16)
        labels = np.empty((n, crop, crop), dtype=np.int32)
        for k, (i, y0, x0) in enumerate(zip(indices, ys, xs)):
            s = self.source[int(i)]
            img = s.x[..., y0 : y0 + crop, x0 : x0 + crop, :]
            lbl = s.y[y0 : y0 + crop, x0 : x0 + crop]
            if flip_h is not None and flip_h[k]:
                img, lbl = img[..., :, ::-1, :], lbl[:, ::-1]
            if flip_v is not None and flip_v[k]:
                img, lbl = img[..., ::-1, :, :], lbl[::-1, :]
            images[k] = img
            labels[k] = lbl
        return HostBatch(images, labels, np.ones(n, dtype=bool))

    def train_batches(self, epoch: int, overfit_batches: int = 0, start: int = 0) -> typing.Iterator[HostBatch]:
        """One epoch of shuffled, randomly cropped and flipped, drop-last
        train batches (``s2tpu/data/pipeline.py:169-207``; flipped here only
        with ``host_flips``).
        ``start`` skips the first batches without reading their images: their
        random draws are still made, so the rest of the stream is the same
        (a preempted epoch's resume)."""
        bs = self.cfg.batch_size
        rng = epoch_rng(self.cfg.shuffle_seed, epoch, overfit_batches)
        order, n_batches = sample_epoch_order(rng, self.train_idx, self._sample_weights, bs, overfit_batches)
        hw = self._sample_hw()
        random_aug = self.cfg.augment and overfit_batches == 0
        rows = self.local_rows()
        for b in range(n_batches):
            idx = order[b * bs : (b + 1) * bs]
            flip_h = flip_v = None
            if random_aug:
                ys = rng.integers(0, hw[0] - self.cfg.random_crop_size + 1, size=bs)
                xs = rng.integers(0, hw[1] - self.cfg.random_crop_size + 1, size=bs)
                if self.cfg.host_flips:
                    flip_h = rng.random(bs) < self.cfg.random_horizontal_flip_p
                    flip_v = rng.random(bs) < self.cfg.random_vertical_flip_p
            else:
                ys = np.full(bs, (hw[0] - self.cfg.random_crop_size) // 2)
                xs = np.full(bs, (hw[1] - self.cfg.random_crop_size) // 2)
            if b < start:
                continue  # the draws only
            if rows is not None:  # the same global draws everywhere; gather only this process's rows
                idx, ys, xs = idx[rows], ys[rows], xs[rows]
                flip_h = flip_h[rows] if flip_h is not None else None
                flip_v = flip_v[rows] if flip_v is not None else None
            yield self._gather_crops(idx, ys, xs, flip_h=flip_h, flip_v=flip_v)

    def eval_batches(self, split: str = "val") -> typing.Iterator[HostBatch]:
        """Center-cropped eval batches, padded to a fixed batch size (under
        several processes, padded with segment 0 under a False mask, then
        this process's slice)."""
        bs = self.cfg.batch_size * self.cfg.val_batch_size_multiplier
        indices = {"val": self.val_idx, "test": self.test_idx, "train": self.train_idx}[split]
        hw = self._sample_hw()
        y0 = (hw[0] - self.cfg.random_crop_size) // 2
        x0 = (hw[1] - self.cfg.random_crop_size) // 2
        for b in range(0, len(indices), bs):
            idx = indices[b : b + bs]
            if self.n_proc > 1:
                mask = np.arange(bs) < len(idx)
                sl = local_slice(bs, self.n_proc, self.proc)
                idx, mask = np.concatenate([idx, np.zeros(bs - len(idx), idx.dtype)])[sl], mask[sl]
                batch = self._gather_crops(idx, np.full(len(idx), y0), np.full(len(idx), x0))
                yield HostBatch(batch.images, batch.labels, mask)
                continue
            batch = self._gather_crops(idx, np.full(len(idx), y0), np.full(len(idx), x0))
            if len(idx) < bs:
                pad = bs - len(idx)
                batch = HostBatch(
                    np.concatenate([batch.images, np.zeros((pad, *batch.images.shape[1:]), batch.images.dtype)]),
                    np.concatenate([batch.labels, np.zeros((pad, *batch.labels.shape[1:]), batch.labels.dtype)]),
                    np.concatenate([batch.mask, np.zeros(pad, dtype=bool)]),
                )
            yield batch


def prefetch_to_device(
    iterator: typing.Iterator[HostBatch], device: torch.device, depth: int = 2
) -> typing.Iterator[DeviceBatch]:
    """Background-thread host-to-device pipeline (``s2tpu/data/pipeline.py:244-283``).

    A producer thread pins each batch and starts non-blocking copies on a
    stream of its own (on the card), so the copies overlap the consumer's
    compute; the consumer waits on that stream's event before it uses a
    batch. Producer exceptions are re-raised in the consumer instead of
    silently truncating the epoch. A consumer that stops early (a
    preempted epoch) stops the producer too. Labels arrive as int32.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    closed = threading.Event()
    error: list[BaseException] = []
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None

    def to_device(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(device, non_blocking=True) if on_card else t

    def produce() -> None:
        try:
            for batch in iterator:
                if on_card:
                    with torch.cuda.stream(copy_stream):
                        out = DeviceBatch(*(to_device(a) for a in batch))
                        event = torch.cuda.Event()
                        event.record(copy_stream)
                else:
                    out, event = DeviceBatch(*(to_device(a) for a in batch)), None
                q.put((out, event))
                if closed.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            error.append(e)
        finally:
            q.put(stop)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                thread.join()
                if error:
                    raise error[0]
                return
            batch, event = item
            if event is not None:
                torch.cuda.current_stream(device).wait_event(event)
                for t in batch:
                    t.record_stream(torch.cuda.current_stream(device))
            yield batch
    finally:
        closed.set()
        while thread.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
