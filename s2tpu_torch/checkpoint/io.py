"""The port's checkpoint directory: ``config.json`` + ``model.pt``.

``config.json`` is the same dict ``s2tpu``'s CheckpointManager writes
(``config_to_dict``), so either package's config parses here;
``model.pt`` is the model's state dict (reference PyTorch naming).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from s2tpu_torch.configs.segmentation import Config, config_from_dict, config_to_dict

CONFIG_FILE = "config.json"
WEIGHTS_FILE = "model.pt"


def save_checkpoint(ckpt_dir: str | Path, config: Config, state_dict: dict[str, torch.Tensor]) -> Path:
    """Write ``config.json`` and ``model.pt`` (tensors moved to the CPU)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    (ckpt_dir / CONFIG_FILE).write_text(json.dumps(config_to_dict(config), default=str, indent=2))
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, ckpt_dir / WEIGHTS_FILE)
    return ckpt_dir


def load_checkpoint(ckpt_dir: str | Path) -> tuple[Config, dict[str, torch.Tensor]]:
    """-> (config, CPU state dict)."""
    ckpt_dir = Path(ckpt_dir)
    config_path, weights_path = ckpt_dir / CONFIG_FILE, ckpt_dir / WEIGHTS_FILE
    if not config_path.exists() or not weights_path.exists():
        raise FileNotFoundError(f"{ckpt_dir} lacks {CONFIG_FILE} or {WEIGHTS_FILE}")
    config = config_from_dict(json.loads(config_path.read_text()))
    state_dict = torch.load(weights_path, map_location="cpu", weights_only=True)
    return config, state_dict
