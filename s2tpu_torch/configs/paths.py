"""On-disk layout: data, log, checkpoint and output roots (the port's copy of
``s2tpu/configs/paths.py``), with the pretrained-weights directory. The root is
overridable via ``S2TPU_ROOT``."""

from __future__ import annotations

import os
from pathlib import Path

ROOT_DIR: Path = Path(os.environ.get("S2TPU_ROOT", Path(__file__).resolve().parents[2]))
DATA_DIR: Path = ROOT_DIR / "data"
LOG_DIR: Path = ROOT_DIR / "logs"
CKPT_DIR: Path = ROOT_DIR / "ckpts"
OUT_DIR: Path = ROOT_DIR / "out"
WEIGHTS_DIR: Path = ROOT_DIR / "weights"
