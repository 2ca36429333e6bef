"""Dataset statistics: streaming per-band mean/std, class distribution and
sample weights (the port's copy of ``s2tpu/data/statistics.py``)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from s2tpu_torch.data.dataset import SegmentSource


class Welford:
    """Numerically stable streaming mean/std over a reduction axis set."""

    def __init__(self) -> None:
        self.count = 0
        self.mean: np.ndarray | None = None
        self.m2: np.ndarray | None = None

    def update(self, batch: np.ndarray, band_axis: int = -1) -> None:
        """Fold a batch (any shape) reducing all axes except `band_axis`."""
        x = np.moveaxis(np.asarray(batch, dtype=np.float64), band_axis, -1)
        x = x.reshape(-1, x.shape[-1])
        n_b = x.shape[0]
        mean_b = x.mean(axis=0)
        m2_b = ((x - mean_b) ** 2).sum(axis=0)
        if self.mean is None:
            self.count, self.mean, self.m2 = n_b, mean_b, m2_b
            return
        delta = mean_b - self.mean
        total = self.count + n_b
        self.mean = self.mean + delta * n_b / total
        self.m2 = self.m2 + m2_b + delta**2 * self.count * n_b / total
        self.count = total

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        assert self.mean is not None and self.count > 1
        return self.mean, np.sqrt(self.m2 / (self.count - 1))


def calculate_mean_std(source: SegmentSource, save_path: str | Path | None = None) -> dict:
    """One streaming pass over the full-resolution segments -> per-band stats."""
    w = Welford()
    for i in range(len(source)):
        w.update(source[i].x, band_axis=-1)
    mean, std = w.finalize()
    stats = {"mean": mean.tolist(), "std": std.tolist()}
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        Path(save_path).write_text(json.dumps(stats))
    return stats


def load_mean_std(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    stats = json.loads(Path(path).read_text())
    return np.asarray(stats["mean"], np.float32), np.asarray(stats["std"], np.float32)


def get_class_probabilities(
    source: SegmentSource,
    num_classes: int,
    ignore_zero_label: bool,
    max_samples: int = 2500,
    seed: int = 0,
) -> np.ndarray:
    """Label-frequency distribution over a random subsample of segments."""
    rng = np.random.default_rng(seed)
    n = len(source)
    idxs = rng.choice(n, size=min(max_samples, n), replace=False)
    counts = np.zeros(num_classes, dtype=np.int64)
    for i in idxs:
        counts += np.bincount(np.asarray(source[int(i)].y).ravel(), minlength=num_classes)[:num_classes]
    if ignore_zero_label:
        counts[0] = 0
    total = counts.sum()
    return counts / total if total > 0 else np.full(num_classes, 1.0 / num_classes)


def get_sample_weights(
    source: SegmentSource,
    class_distribution: np.ndarray,
    ignore_zero_label: bool = False,
) -> np.ndarray:
    """Weighted-sampling weights: deviation of each sample's local class mix
    from the global distribution (rare-class-rich samples get drawn more)."""
    global_dist = np.asarray(class_distribution, dtype=np.float64)
    k = len(global_dist)
    weights = np.empty(len(source), dtype=np.float64)
    for i in range(len(source)):
        local = np.bincount(np.asarray(source[i].y).ravel(), minlength=k)[:k].astype(np.float64)
        if ignore_zero_label:
            local[0] = 0
        s = local.sum()
        local = local / s if s > 0 else local
        weights[i] = np.abs(local - global_dist).sum()
    total = weights.sum()
    return (weights / total if total > 0 else np.full(len(source), 1.0 / len(source))).astype(np.float32)
