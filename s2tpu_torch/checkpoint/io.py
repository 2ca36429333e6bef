"""The port's checkpoints: a single serving checkpoint or a training run directory.

A serving checkpoint is ``config.json`` + ``model.pt`` (the model's state
dict, reference PyTorch naming). ``config.json`` is the same dict
``s2tpu``'s CheckpointManager writes (``config_to_dict``), so either
package's config parses here.

A training run directory holds ``config.json`` and one ``epoch_<n>/`` per
kept epoch with ``model.pt``, ``optimizer.pt`` (Adam's state dict),
``master.pt`` and ``ema.pt`` where the run keeps an f32 master or a
parameter EMA (parameter name -> f32 tensor), and ``state.json`` (the
optimizer step and the epoch's scalar metrics). :class:`CheckpointManager`
keeps the ``keep`` best epochs by its monitor and mode plus the latest, as
``s2tpu/checkpoint/orbax_io.py`` retains best and last. After a SIGTERM the
trainers write the same files to ``preempt/``, whose ``state.json`` also
records the interrupted epoch and its trained batches (``orbax_io.py:103-172``).
An MAE run directory has the same layout with an ``MAEConfig`` in
``config.json`` and the Prithvi MAE's state dict (published layout) in
``model.pt``. :func:`load_checkpoint` reads either segmentation layout and
:func:`load_mae_checkpoint` an MAE run, the latest epoch by default, with
``ema=True`` the EMA in place of the parameters where the run kept one.

Several processes of one run (a data axis) share its directory: the trainers
write through :func:`on_rank0`, so rank 0 writes, every rank waits at a
barrier until it has, and then every rank reads what it wrote. The files
always hold whole tensors: a trainer whose parameters are sharded over a
model axis (FSDP) gathers them, its Adam moments, master and EMA before
rank 0 writes them, and slices what it reads, so its run directories and a
one-rank run's load into each other and serve alike.
"""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path

import torch
import torch.distributed as dist

from s2tpu_torch.configs.mae import MAEConfig
from s2tpu_torch.configs.mae import config_from_dict as mae_config_from_dict
from s2tpu_torch.configs.segmentation import Config, config_from_dict, config_to_dict

CONFIG_FILE = "config.json"
WEIGHTS_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"
MASTER_FILE = "master.pt"
EMA_FILE = "ema.pt"
STATE_FILE = "state.json"
EPOCH_PREFIX = "epoch_"
PREEMPT_DIR = "preempt"


def on_rank0(write) -> None:
    """``write()`` on rank 0 of the process group (or in the one process
    there is), then a barrier of every rank, so that none reads or writes
    the run directory before rank 0 is done."""
    several = dist.is_initialized() and dist.get_world_size() > 1
    if not several or dist.get_rank() == 0:
        write()
    if several:
        dist.barrier()


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


def _load_config_and_weights(
    ckpt_dir: str | Path, epoch: int | None, ema: bool = False
) -> tuple[dict, dict[str, torch.Tensor]]:
    """-> (config dict, CPU state dict) of a serving checkpoint, or of a
    training run directory's ``epoch`` (default: its latest); with ``ema``
    and a run configured with ``train.ema_decay``, the f32 EMA replaces the
    parameters (``s2tpu/cli/convert_weights.py:143-176``)."""
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
    config = json.loads(config_path.read_text())
    if ema and (config.get("train") or {}).get("ema_decay"):
        ema_path = weights_path.parent / EMA_FILE
        if not ema_path.exists():
            raise FileNotFoundError(f"{ckpt_dir} was trained with ema_decay but {ema_path} is missing; "
                                    "pass --no-ema for the raw weights")
        state_dict = {**state_dict, **torch.load(ema_path, map_location="cpu", weights_only=True)}
    return config, state_dict


def load_checkpoint(
    ckpt_dir: str | Path, epoch: int | None = None, ema: bool = False
) -> tuple[Config, dict[str, torch.Tensor]]:
    """-> (segmentation config, CPU state dict) of a serving checkpoint, or of
    a training run directory's ``epoch`` (default: its latest); ``ema``: the
    EMA's parameters where the run kept one."""
    config, state_dict = _load_config_and_weights(ckpt_dir, epoch, ema)
    return config_from_dict(config), state_dict


def load_mae_checkpoint(
    run_dir: str | Path, epoch: int | None = None, ema: bool = False
) -> tuple[MAEConfig, dict[str, torch.Tensor]]:
    """-> (MAE config, CPU state dict in the published Prithvi layout) of an
    MAE run directory's ``epoch`` (default: its latest); ``ema``: the EMA's
    parameters where the run kept one."""
    config, state_dict = _load_config_and_weights(run_dir, epoch, ema)
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
        self, epoch: int, model: torch.nn.Module | dict, optimizer: torch.optim.Optimizer | dict, step: int,
        metrics: dict | None = None, master: dict | None = None, ema: dict | None = None,
    ) -> None:
        """Write epoch ``epoch`` (``state.json`` last, so a partial write is
        never taken for a checkpoint), then drop epochs outside best + latest."""
        scalars = {k: float(v) for k, v in (metrics or {}).items() if isinstance(v, (int, float))}
        _write_state(self._epoch_dir(epoch), model, optimizer, master, ema,
                     {"epoch": epoch, "step": step, "metrics": scalars})
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
        """-> {"model", "optimizer", "master", "ema": state dicts (None where
        not kept), "step": int} on the CPU."""
        d = self._epoch_dir(epoch)
        if not (d / STATE_FILE).exists():
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} under {self.directory}")
        return _read_state(d)

    # -- preemption --------------------------------------------------------
    def save_preempt(
        self, epoch: int, batches_done: int, model: torch.nn.Module | dict, optimizer: torch.optim.Optimizer | dict,
        step: int, master: dict | None = None, ema: dict | None = None,
    ) -> None:
        """The whole training state at a step boundary of ``epoch`` after
        ``batches_done`` of its batches, outside the kept epochs."""
        _write_state(self.directory / PREEMPT_DIR, model, optimizer, master, ema,
                     {"epoch": epoch, "batches_done": batches_done, "step": step})

    def has_preempt(self) -> bool:
        return (self.directory / PREEMPT_DIR / STATE_FILE).exists()

    def preempt_epoch(self) -> int:
        """The interrupted epoch (the marker alone: the trainer matches its
        optimizer to it before restoring)."""
        return json.loads((self.directory / PREEMPT_DIR / STATE_FILE).read_text())["epoch"]

    def restore_preempt(self) -> dict:
        """``restore``'s dict for the preemption checkpoint, with its
        "epoch" and "batches_done"."""
        return _read_state(self.directory / PREEMPT_DIR)

    def clear_preempt(self) -> None:
        shutil.rmtree(self.directory / PREEMPT_DIR, ignore_errors=True)


def _write_state(
    d: Path, model: torch.nn.Module | dict, optimizer: torch.optim.Optimizer | dict, master: dict | None,
    ema: dict | None, state: dict,
) -> None:
    """``d`` := the model, Adam (each a module and an optimizer, or their
    state dicts), the master and EMA where kept, and ``state.json`` last (a
    directory without it is no checkpoint)."""
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    torch.save(_cpu(model.state_dict() if isinstance(model, torch.nn.Module) else model), d / WEIGHTS_FILE)
    torch.save(optimizer if isinstance(optimizer, dict) else optimizer.state_dict(), d / OPTIMIZER_FILE)
    for name, part in ((MASTER_FILE, master), (EMA_FILE, ema)):
        if part is not None:
            torch.save(_cpu(part), d / name)
    (d / STATE_FILE).write_text(json.dumps(state))


def _read_state(d: Path) -> dict:
    def load(name: str):
        return torch.load(d / name, map_location="cpu", weights_only=True) if (d / name).exists() else None

    return {
        "model": load(WEIGHTS_FILE), "optimizer": load(OPTIMIZER_FILE), "master": load(MASTER_FILE),
        "ema": load(EMA_FILE), **json.loads((d / STATE_FILE).read_text()),
    }
