"""Batch-inference output writers.

Parity with reference inference_demo.py:14-29 (CustomWriter saving per-batch
logits) plus the GeoTIFF class-map writer the reference lacks: predictions
land as georeferenced uint8 rasters alongside .npy logits, so outputs drop
straight into GIS tooling.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from s2tpu_torch.geo.tiff import GeoInfo, write_geotiff


class PredictionWriter:
    def __init__(self, out_dir: str | Path, save_logits: bool = True, prefix: str = "") -> None:
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.save_logits = save_logits
        # Per-process namespace under multi-host serving (e.g. "p1_"): batch
        # files are sequence-numbered, so concurrent writers need disjoint
        # names. Class maps are keyed by segment id — disjoint by design.
        self.prefix = prefix
        self._batch_idx = 0

    def write_batch(self, logits: np.ndarray) -> Path:
        """Save raw logits for one batch (reference CustomWriter contract)."""
        path = self.out_dir / f"{self.prefix}batch_{self._batch_idx}.npy"
        np.save(path, np.asarray(logits))
        self._batch_idx += 1
        return path

    def write_class_map(
        self, segment_id: int, class_map: np.ndarray, geo: GeoInfo | None = None
    ) -> Path:
        path = self.out_dir / f"pred_{segment_id}.tif"
        write_geotiff(path, class_map.astype(np.uint8), geo=geo)
        return path
