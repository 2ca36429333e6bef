"""The port's checkpoints: a single serving checkpoint or a training run directory.

A serving checkpoint is ``config.json`` + ``model.pt`` (the model's state
dict, reference PyTorch naming). ``config.json`` is the same dict
``s2tpu``'s CheckpointManager writes (``config_to_dict``), so either
package's config parses here.

A training run directory holds ``config.json`` and one ``epoch_<n>/`` per
kept epoch with ``model.pt``, ``optimizer.pt`` and ``state.json`` (the
optimizer step and the epoch's scalar metrics). :class:`CheckpointManager`
keeps the ``keep`` best epochs by its monitor and mode plus the latest, as
``s2tpu/checkpoint/orbax_io.py`` retains best and last. An MAE run directory
has the same layout with an ``MAEConfig`` in ``config.json`` and the
Prithvi MAE's state dict (published layout) in ``model.pt``.
:func:`load_checkpoint` reads either segmentation layout and
:func:`load_mae_checkpoint` an MAE run, the latest epoch by default.
"""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path

import torch

from s2tpu_torch.configs.mae import MAEConfig
from s2tpu_torch.configs.mae import config_from_dict as mae_config_from_dict
from s2tpu_torch.configs.segmentation import Config, config_from_dict, config_to_dict

CONFIG_FILE = "config.json"
WEIGHTS_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"
STATE_FILE = "state.json"
EPOCH_PREFIX = "epoch_"


def _cpu(state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def save_checkpoint(ckpt_dir: str | Path, config: Config, state_dict: dict[str, torch.Tensor]) -> Path:
    """Write ``config.json`` and ``model.pt`` (tensors moved to the CPU)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    (ckpt_dir / CONFIG_FILE).write_text(json.dumps(config_to_dict(config), default=str, indent=2))
    torch.save(_cpu(state_dict), ckpt_dir / WEIGHTS_FILE)
    return ckpt_dir


def epochs_in(run_dir: str | Path) -> list[int]:
    """Epochs with a complete checkpoint under a run directory, ascending."""
    run_dir = Path(run_dir)
    if not run_dir.is_dir():
        return []
    return sorted(
        int(p.name[len(EPOCH_PREFIX):]) for p in run_dir.glob(f"{EPOCH_PREFIX}*")
        if p.name[len(EPOCH_PREFIX):].isdigit() and (p / STATE_FILE).exists()
    )


def _load_config_and_weights(ckpt_dir: str | Path, epoch: int | None) -> tuple[dict, dict[str, torch.Tensor]]:
    """-> (config dict, CPU state dict) of a serving checkpoint, or of a
    training run directory's ``epoch`` (default: its latest)."""
    ckpt_dir = Path(ckpt_dir)
    config_path = ckpt_dir / CONFIG_FILE
    if epoch is None and (ckpt_dir / WEIGHTS_FILE).exists():
        weights_path = ckpt_dir / WEIGHTS_FILE
    else:
        epochs = epochs_in(ckpt_dir)
        if epoch is None and epochs:
            epoch = epochs[-1]
        if epoch not in epochs:
            raise FileNotFoundError(f"{ckpt_dir} has no checkpoint for epoch {epoch} (epochs: {epochs})")
        weights_path = ckpt_dir / f"{EPOCH_PREFIX}{epoch}" / WEIGHTS_FILE
    if not config_path.exists() or not weights_path.exists():
        raise FileNotFoundError(f"{ckpt_dir} lacks {CONFIG_FILE} or {weights_path.name}")
    state_dict = torch.load(weights_path, map_location="cpu", weights_only=True)
    return json.loads(config_path.read_text()), state_dict


def load_checkpoint(ckpt_dir: str | Path, epoch: int | None = None) -> tuple[Config, dict[str, torch.Tensor]]:
    """-> (segmentation config, CPU state dict) of a serving checkpoint, or of
    a training run directory's ``epoch`` (default: its latest)."""
    config, state_dict = _load_config_and_weights(ckpt_dir, epoch)
    return config_from_dict(config), state_dict


def load_mae_checkpoint(run_dir: str | Path, epoch: int | None = None) -> tuple[MAEConfig, dict[str, torch.Tensor]]:
    """-> (MAE config, CPU state dict in the published Prithvi layout) of an
    MAE run directory's ``epoch`` (default: its latest)."""
    config, state_dict = _load_config_and_weights(run_dir, epoch)
    return mae_config_from_dict(config), state_dict


class CheckpointManager:
    """Epoch checkpoints of a training run: the ``keep`` best by ``monitor``
    (``mode`` "min" or "max") plus the latest are kept."""

    def __init__(
        self, directory: str | Path, keep: int = 1, monitor: str = "val/loss", mode: str = "min",
        config_dict: dict | None = None,
    ) -> None:
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep, self.monitor, self.mode = keep, monitor, mode
        if config_dict is not None:
            (self.directory / CONFIG_FILE).write_text(json.dumps(config_dict, default=str, indent=2))

    def _epoch_dir(self, epoch: int) -> Path:
        return self.directory / f"{EPOCH_PREFIX}{epoch}"

    def _score(self, epoch: int) -> float:
        """Lower is better; an epoch without the monitored metric ranks last."""
        metrics = json.loads((self._epoch_dir(epoch) / STATE_FILE).read_text())["metrics"]
        value = metrics.get(self.monitor)
        if value is None or not math.isfinite(value):
            return math.inf
        return value if self.mode == "min" else -value

    def save_epoch(
        self, epoch: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int,
        metrics: dict | None = None,
    ) -> None:
        """Write epoch ``epoch`` (``state.json`` last, so a partial write is
        never taken for a checkpoint), then drop epochs outside best + latest."""
        d = self._epoch_dir(epoch)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        torch.save(_cpu(model.state_dict()), d / WEIGHTS_FILE)
        torch.save(optimizer.state_dict(), d / OPTIMIZER_FILE)
        scalars = {k: float(v) for k, v in (metrics or {}).items() if isinstance(v, (int, float))}
        (d / STATE_FILE).write_text(json.dumps({"epoch": epoch, "step": step, "metrics": scalars}))
        epochs = epochs_in(self.directory)
        kept = set(sorted(epochs, key=lambda e: (self._score(e), -e))[: self.keep]) | {epochs[-1]}
        for e in epochs:
            if e not in kept:
                shutil.rmtree(self._epoch_dir(e))

    def latest_epoch(self) -> int | None:
        epochs = epochs_in(self.directory)
        return epochs[-1] if epochs else None

    def best_epoch(self) -> int | None:
        """The kept epoch best by the monitor (the later of a tie), None when
        no epoch records it (``s2tpu/checkpoint/orbax_io.py:68``)."""
        scored = [e for e in epochs_in(self.directory) if math.isfinite(self._score(e))]
        return min(scored, key=lambda e: (self._score(e), -e)) if scored else None

    def restore(self, epoch: int) -> dict:
        """-> {"model": state dict, "optimizer": state dict, "step": int} on the CPU."""
        d = self._epoch_dir(epoch)
        if not (d / STATE_FILE).exists():
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} under {self.directory}")
        return {
            "model": torch.load(d / WEIGHTS_FILE, map_location="cpu", weights_only=True),
            "optimizer": torch.load(d / OPTIMIZER_FILE, map_location="cpu", weights_only=True),
            "step": json.loads((d / STATE_FILE).read_text())["step"],
        }
