"""Hyperparameter tuning: random search + ASHA-style pruning over short fits (the port of ``s2tpu/train/tune.py``).

A self-contained search loop (optuna optional) over a declarative
9-dimension search space -- optimizer (lr, weight decay), loss (type, focal
gamma, class weighting), schedule (type, warmup), and data geometry (crop,
batch size) -- scoring each trial by best validation loss over a short fit.
The same seed draws the same trials as the JAX package's tuner, and the
same validation losses prune the same trials.

Trials are pruned ASHA-style (successive halving, arXiv:1810.05934): each
trial trains rung by rung (budgets ``epochs_per_trial / eta^k``); after a
rung, a trial continues only if its val loss sits in the top ``1/eta`` of
all results recorded at that rung so far. Early rungs are free (nothing to
compare against), so the first trials establish the bar asynchronously --
no synchronization barrier between trials.

Each trial builds a new ``SegmentationTrainer`` on ``device`` (the card
unless the caller asks for the CPU) and releases it before the next, so
device memory does not grow from trial to trial.
"""


from __future__ import annotations

import copy
import dataclasses
import gc
import math
import typing

import numpy as np

from s2tpu_torch.configs.segmentation import Config, LossType, LRSchedulerType
from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class SearchSpace:
    """Declarative search dimensions. An empty tuple / single choice pins a
    dimension; crop/batch choices must fit the dataset (the CLI passes the
    configured values as the center of each range)."""

    lr_log_range: tuple[float, float] = (1e-5, 1e-2)
    weight_decay_log_range: tuple[float, float] = (1e-4, 1e-1)
    loss_types: tuple[str, ...] = ("ce", "focal", "dice_focal")
    focal_gammas: tuple[float, ...] = (1.0, 2.0, 3.0)
    weighted_loss: tuple[bool, ...] = (False, True)
    # None -> constant lr (the reference's default); cosine uses max_lr=lr.
    scheduler_types: tuple[str | None, ...] = (None, "step", "cosine")
    warmup_epochs: tuple[int, ...] = (0, 1)  # cosine only
    crop_sizes: tuple[int, ...] = ()  # () = keep the configured crop
    batch_sizes: tuple[int, ...] = ()  # () = keep the configured batch size


@dataclasses.dataclass
class TrialResult:
    params: dict
    val_loss: float
    val_iou: float
    history: list[dict]
    pruned: bool = False
    epochs_trained: int = 0


def sample_trial(space: SearchSpace, rng: np.random.Generator) -> dict:
    log_u = lambda lo, hi: float(math.exp(rng.uniform(math.log(lo), math.log(hi))))  # noqa: E731
    choice = lambda xs: xs[int(rng.integers(len(xs)))]  # keeps None/bool types intact  # noqa: E731
    params = {
        "lr": log_u(*space.lr_log_range),
        "weight_decay": log_u(*space.weight_decay_log_range),
        "loss_type": str(choice(space.loss_types)),
        "focal_loss_gamma": float(choice(space.focal_gammas)),
        "weighted_loss": bool(choice(space.weighted_loss)),
        "lr_scheduler_type": choice(space.scheduler_types),
        "warmup_epochs": int(choice(space.warmup_epochs)),
    }
    if space.crop_sizes:
        params["random_crop_size"] = int(choice(space.crop_sizes))
    if space.batch_sizes:
        params["batch_size"] = int(choice(space.batch_sizes))
    return params


def apply_trial(config: Config, params: dict, epochs_per_trial: int | None = None) -> Config:
    config = copy.deepcopy(config)
    t = config.train
    t.lr = params["lr"]
    t.weight_decay = params["weight_decay"]
    t.loss_type = LossType(params["loss_type"])
    t.focal_loss_gamma = params["focal_loss_gamma"]
    t.weighted_loss = params["weighted_loss"]
    sched = params.get("lr_scheduler_type")
    t.lr_scheduler_type = LRSchedulerType(sched) if sched else None
    if sched == "cosine":
        # One cycle spanning the trial: peak at the sampled lr, linear warmup.
        t.cosine_lr_sched_max_lr = params["lr"]
        t.cosine_lr_sched_min_lr = params["lr"] / 100.0
        t.cosine_lr_sched_first_cycle_steps = max(epochs_per_trial or 10, 2)
        t.cosine_lr_sched_warmup_steps = min(
            params.get("warmup_epochs", 0), t.cosine_lr_sched_first_cycle_steps - 1
        )
    elif sched == "step":
        t.step_lr_sched_step_size = max((epochs_per_trial or 3) // 3, 1)
        t.step_lr_sched_gamma = 0.5
    if "random_crop_size" in params:
        config.datamodule.random_crop_size = params["random_crop_size"]
    if "batch_size" in params:
        config.datamodule.batch_size = params["batch_size"]
    return config


def _sample_trial_optuna(optuna_trial, space: SearchSpace) -> dict:
    """Draw one parameter set through optuna's suggest API (TPE sampling)."""
    params = {
        "lr": optuna_trial.suggest_float("lr", *space.lr_log_range, log=True),
        "weight_decay": optuna_trial.suggest_float(
            "weight_decay", *space.weight_decay_log_range, log=True
        ),
        "loss_type": optuna_trial.suggest_categorical("loss_type", list(space.loss_types)),
        "focal_loss_gamma": optuna_trial.suggest_categorical(
            "focal_loss_gamma", list(space.focal_gammas)
        ),
        "weighted_loss": optuna_trial.suggest_categorical(
            "weighted_loss", list(space.weighted_loss)
        ),
        "lr_scheduler_type": optuna_trial.suggest_categorical(
            "lr_scheduler_type", list(space.scheduler_types)
        ),
        "warmup_epochs": optuna_trial.suggest_categorical(
            "warmup_epochs", list(space.warmup_epochs)
        ),
    }
    if space.crop_sizes:
        params["random_crop_size"] = optuna_trial.suggest_categorical(
            "random_crop_size", list(space.crop_sizes)
        )
    if space.batch_sizes:
        params["batch_size"] = optuna_trial.suggest_categorical(
            "batch_size", list(space.batch_sizes)
        )
    return params


def asha_rungs(max_epochs: int, eta: int = 2) -> list[int]:
    """Cumulative epoch budgets [floor(R/eta^k) ... R], smallest first
    (e.g. R=5, eta=2 -> [1, 2, 5]); the k-th halving floors, so the first
    pruning decision happens as early as possible."""
    rungs, budget = [], max_epochs
    while budget >= 1:
        rungs.append(int(budget))
        budget = budget // eta
    rungs = sorted(set(rungs))
    return rungs


def tune(
    base_config: Config,
    datamodule_factory: typing.Callable[[Config], typing.Any],
    n_trials: int = 10,
    epochs_per_trial: int = 3,
    seed: int = 0,
    space: SearchSpace | None = None,
    backend: str = "random",
    eta: int = 2,
    device=None,
) -> list[TrialResult]:
    """Run hyperparameter-search trials; returns results sorted best-first
    (completed trials rank above pruned ones at equal loss).

    backend="random" (default, dependency-free) or "optuna" (TPE sampling —
    the reference's declared-but-stubbed tuner, train_segmentation.py:284-289;
    falls back to random search with a warning when optuna is not installed).
    ``eta <= 1`` disables pruning (every trial runs the full budget).
    Trials train on ``device`` (``resolve_device``: the card unless "cpu").
    """
    import torch

    from s2tpu_torch.train.trainer import SegmentationTrainer

    space = space or SearchSpace()
    results: list[TrialResult] = []
    rungs = asha_rungs(epochs_per_trial, eta) if eta > 1 else [epochs_per_trial]
    rung_records: dict[int, list[float]] = {r: [] for r in rungs}

    def run_trial(trial_idx: int, params: dict) -> TrialResult:
        cfg = apply_trial(base_config, params, epochs_per_trial)
        dm = datamodule_factory(cfg)
        trainer = SegmentationTrainer(cfg, dm, device=device)
        history: list[dict] = []
        pruned = False
        done = 0
        for rung in rungs:
            history += trainer.fit(epochs=rung, start_epoch=done)
            done = rung
            rung_losses = [h.get("val/loss", float("inf")) for h in history]
            best_so_far = float(np.min(rung_losses))
            records = sorted(rung_records[rung] + [best_so_far])
            rung_records[rung] = records
            if rung == rungs[-1]:
                break
            # ASHA promotion: continue only in the top floor(n/eta) of this
            # rung's records so far (vacuously true while records are scarce —
            # the first eta-1 trials always promote, establishing the bar).
            k = len(records) // eta
            if k >= 1 and best_so_far > records[k - 1]:
                pruned = True
                logger.info(
                    f"trial {trial_idx}: pruned at rung {rung} "
                    f"(val_loss {best_so_far:.4f} > cutoff {records[k - 1]:.4f})"
                )
                break
        # Release the trial's model and Adam state before the next trial
        # builds its own; gc frees any reference cycle among them now.
        del trainer, dm
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        val_losses = [h.get("val/loss", float("inf")) for h in history]
        val_ious = [h.get("val/iou", 0.0) for h in history]
        best = int(np.argmin(val_losses))
        result = TrialResult(
            params, float(val_losses[best]), float(val_ious[best]), history,
            pruned=pruned, epochs_trained=done,
        )
        results.append(result)
        logger.info(
            f"trial {trial_idx}: {params} -> val_loss {result.val_loss:.4f} "
            f"iou {result.val_iou:.4f}"
            + (f" (pruned @ {done} epochs)" if pruned else "")
        )
        return result

    if backend == "optuna":
        try:
            import optuna
        except ImportError:
            logger.warning("optuna not installed — falling back to random search")
            backend = "random"
        else:
            study = optuna.create_study(
                direction="minimize", sampler=optuna.samplers.TPESampler(seed=seed)
            )

            def objective(trial) -> float:
                params = _sample_trial_optuna(trial, space)
                return run_trial(trial.number, params).val_loss

            study.optimize(objective, n_trials=n_trials)
            return sorted(results, key=lambda r: (r.pruned, r.val_loss))

    rng = np.random.default_rng(seed)
    for trial in range(n_trials):
        run_trial(trial, sample_trial(space, rng))
    return sorted(results, key=lambda r: (r.pruned, r.val_loss))
