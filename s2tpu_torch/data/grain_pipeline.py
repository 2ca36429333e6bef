"""Grain-based host input pipeline, an optional backend: the port of ``s2tpu/data/grain_pipeline.py``.

The default pipeline (``s2tpu_torch.data.pipeline``) is a thread, the
native gather and a pinned prefetch, best for packed memmap corpora. For
sources where per-item decode is the bottleneck (TiffSource's GeoTIFF codec
on huge AOIs, remote filesystems), Grain supplies deterministic multi-worker
prefetching: this module wraps any SegmentSource as a grain.MapDataset
pipeline that emits the port's ``HostBatch``, so ``prefetch_to_device`` and
the trainers consume it unchanged. Gated on the ``grain`` package, imported
where a pipeline is built: the port never requires it.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from s2tpu_torch.configs.segmentation import DatamoduleConfig
from s2tpu_torch.data.dataset import SegmentSource
from s2tpu_torch.data.pipeline import HostBatch


def grain_available() -> bool:
    try:
        import grain  # noqa: F401

        return True
    except ImportError:
        return False


@dataclasses.dataclass
class _CropAugment:
    """Random crop (+ optional H/V flips) keyed by grain's per-record rng."""

    crop: int
    p_horizontal: float
    p_vertical: float
    augment: bool

    def __call__(self, sample, rng: np.random.Generator):
        x, y = np.asarray(sample.x), np.asarray(sample.y)
        h, w = x.shape[-3], x.shape[-2]
        if self.augment:
            y0 = int(rng.integers(0, h - self.crop + 1))
            x0 = int(rng.integers(0, w - self.crop + 1))
        else:
            y0, x0 = (h - self.crop) // 2, (w - self.crop) // 2
        img = x[..., y0 : y0 + self.crop, x0 : x0 + self.crop, :]
        lbl = y[y0 : y0 + self.crop, x0 : x0 + self.crop]
        if self.augment and rng.random() < self.p_horizontal:
            img, lbl = img[..., :, ::-1, :], lbl[:, ::-1]
        if self.augment and rng.random() < self.p_vertical:
            img, lbl = img[..., ::-1, :, :], lbl[::-1, :]
        return np.ascontiguousarray(img), np.ascontiguousarray(lbl.astype(np.int32))


class _SubsetSource:
    """Random-access view of a SegmentSource restricted to split indices."""

    def __init__(self, source: SegmentSource, indices: np.ndarray) -> None:
        self._source = source
        self._indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, i: int):
        return self._source[int(self._indices[i])]


def grain_train_batches(
    source: SegmentSource,
    train_idx: np.ndarray,
    cfg: DatamoduleConfig,
    epoch: int,
    worker_count: int = 0,
) -> typing.Iterator[HostBatch]:
    """One epoch of shuffled, cropped, drop-last train batches through Grain.

    worker_count > 0 moves decode+crop into that many subprocesses
    (grain.multiprocessing); 0 stays in-process (deterministic, test-friendly).
    """
    import grain

    transform = _CropAugment(
        crop=cfg.random_crop_size,
        p_horizontal=cfg.random_horizontal_flip_p,
        p_vertical=cfg.random_vertical_flip_p,
        augment=cfg.augment,
    )
    ds = (
        grain.MapDataset.source(_SubsetSource(source, train_idx))
        .seed(cfg.shuffle_seed + epoch)
        .shuffle()
        .random_map(transform)
        .batch(cfg.batch_size, drop_remainder=True)
    )
    it_ds = ds.to_iter_dataset()
    if worker_count > 0:
        it_ds = it_ds.mp_prefetch(
            grain.MultiprocessingOptions(num_workers=worker_count)
        )
    for images, labels in it_ds:
        yield HostBatch(images, labels, np.ones(images.shape[0], dtype=bool))
