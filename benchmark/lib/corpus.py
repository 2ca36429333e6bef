"""The seeded inputs: a corpus of segments and the draws a run trains on.

A corpus of ``segments`` segments of ``size``^2 x ``bands`` int16 raw DN
(and uint8 labels of ``classes`` classes, where it has labels) is made from
the seed as views of a pool of ``pool`` random segments: segment i is pool
segment ``i % pool`` plus ``i // pool`` DN, so that no two are equal, and
its labels are pool labels ``(7 i) % pool``. The whole corpus is built in
bulk on the host, one ``np.add`` a block of ``pool`` segments; any
segment's crop is worked out again from the pool, which is what the
reference reads.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DN_RANGE = (200, 3800)


class Corpus:
    def __init__(self, seed: int, segments: int, size: int, pool: int, bands: int, classes: int = 0) -> None:
        rng = np.random.default_rng([seed, 40])
        self.n, self.size, self.pool = segments, size, pool
        self.pool_x = rng.integers(*DN_RANGE, size=(pool, size, size, bands), dtype=np.int16)
        self.pool_y = rng.integers(0, classes, size=(pool, size, size), dtype=np.uint8) if classes else None

    def segment(self, i: int) -> np.ndarray:
        return self.pool_x[i % self.pool] + np.int16(i // self.pool)

    def images(self) -> np.ndarray:
        """Every segment, (n, size, size, bands) int16, a block of ``pool`` a
        thread task (the fill is memory-bound and numpy lets go of the GIL)."""
        out = np.empty((self.n, *self.pool_x.shape[1:]), np.int16)

        def fill(start: int) -> None:
            block = out[start:start + self.pool]
            np.add(self.pool_x[:len(block)], np.int16(start // self.pool), out=block)

        run_blocks(fill, range(0, self.n, self.pool))
        return out

    def labels(self) -> np.ndarray | None:
        """Every segment's labels, (n, size, size) uint8 (None without labels)."""
        if self.pool_y is None:
            return None
        out = np.empty((self.n, *self.pool_y.shape[1:]), np.uint8)

        def fill(start: int) -> None:
            ids = np.arange(start, min(start + self.pool, self.n))
            np.take(self.pool_y, (7 * ids) % self.pool, axis=0, out=out[start:start + len(ids)])

        run_blocks(fill, range(0, self.n, self.pool))
        return out

    def crops(self, idx: np.ndarray, ys: np.ndarray, xs: np.ndarray, crop: int):
        """The (B, crop, crop, bands) int16 crops and (B, crop, crop) labels at the draws."""
        images = np.stack([self.segment(i)[y:y + crop, x:x + crop] for i, y, x in zip(idx, ys, xs)])
        if self.pool_y is None:
            return images, None
        labels = np.stack([self.pool_y[(7 * i) % self.pool, y:y + crop, x:x + crop] for i, y, x in zip(idx, ys, xs)])
        return images, labels

    def mean_std(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-band mean and standard deviation of the pool."""
        flat = self.pool_x.reshape(-1, self.pool_x.shape[-1]).astype(np.float64)
        return flat.mean(0).astype(np.float32), flat.std(0).astype(np.float32)

    def class_distribution(self, classes: int, masked: bool) -> list[float]:
        """The pool's label frequencies, the masked background's set to 0."""
        p = np.bincount(self.pool_y.ravel(), minlength=classes).astype(np.float64)
        if masked:
            p[0] = 0.0
        return (p / p.sum()).tolist()


def run_blocks(fill, starts) -> None:
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for f in [pool.submit(fill, s) for s in starts]:
            f.result()


class Draws:
    """Each step's (3, B) int32 segment ids and crop offsets, from the seed:
    the ids walk a permutation of the corpus (a new one when it runs out),
    so the rows of a step, and of the first steps, all differ."""

    def __init__(self, seed: int, n: int, batch: int, max_offset: int) -> None:
        self.rng = np.random.default_rng([seed, 41])
        self.n, self.batch, self.max_offset = n, batch, max_offset
        self.order, self.pos = self.rng.permutation(n), 0

    def step(self) -> np.ndarray:
        if self.pos + self.batch > self.n:
            self.order, self.pos = self.rng.permutation(self.n), 0
        idx = self.order[self.pos:self.pos + self.batch]
        self.pos += self.batch
        ys = self.rng.integers(0, self.max_offset + 1, size=self.batch)
        xs = self.rng.integers(0, self.max_offset + 1, size=self.batch)
        return np.stack([idx, ys, xs]).astype(np.int32)

    def window(self, k: int) -> np.ndarray:
        return np.stack([self.step() for _ in range(k)])
