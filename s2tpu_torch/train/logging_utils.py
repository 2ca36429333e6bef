"""Run logging: the per-run JSONL scalars file and images (the port of ``s2tpu/train/logging_utils.py::RunLogger``).

Scalars land in ``<log_dir>/<run>.metrics.jsonl``, the run's config in
``<log_dir>/<run>.config.json`` and images in ``<log_dir>/<run>/<name>_<step>.png``,
as the JAX package writes them without wandb. wandb is not ported.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class RunLogger:
    def __init__(self, run_name: str, log_dir: str | Path, config: dict | None = None) -> None:
        self.run_name = run_name
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.log_dir / f"{run_name}.metrics.jsonl"
        if config is not None:
            (self.log_dir / f"{run_name}.config.json").write_text(json.dumps(config, default=str, indent=2))

    def log_scalars(self, scalars: dict[str, float], step: int) -> None:
        record = {"step": step, "time": time.time(), **{k: float(v) for k, v in scalars.items()}}
        with self.jsonl_path.open("a") as f:
            f.write(json.dumps(record) + "\n")

    def log_image(self, name: str, image, step: int) -> None:
        """Save a matplotlib figure (closed after saving) or an image array
        as ``<log_dir>/<run>/<name>_<step>.png`` ('/' in the name becomes '_')."""
        from s2tpu_torch.plotting import pyplot

        plt = pyplot()
        img_dir = self.log_dir / self.run_name
        img_dir.mkdir(parents=True, exist_ok=True)
        path = img_dir / f"{name.replace('/', '_')}_{step}.png"
        if hasattr(image, "savefig"):
            image.savefig(path, bbox_inches="tight")
            plt.close(image)
        else:
            plt.imsave(path, image)
