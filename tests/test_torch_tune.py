"""The tuner: s2tpu_torch.train.tune against the JAX package's.

The same seed draws the same trials, the same trial turns into the same
config tree, and, with a stub trainer that reports fixed validation losses,
ASHA prunes the same trials. optuna is installed on neither the test
machine nor the card: its backend is driven through a fake module, and its
absence falls back to random search. One ``--type tune`` CLI run (B0, two
trials, 64^2 crops, f32) trains real trainers on the CPU.
"""

import dataclasses
import json
import logging
import sys
import types

import numpy as np
import pytest
import torch

from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.train import trainer as jax_trainer_mod
from s2tpu.train import tune as jax_tune
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.train import trainer as trainer_mod
from s2tpu_torch.train import tune

SPACES = {
    "default": {},
    "geometry": dict(crop_sizes=(64, 128), batch_sizes=(8, 16)),
    "pinned": dict(loss_types=("ce",), weighted_loss=(False,), scheduler_types=("cosine",)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch CPU threads in this module, as the suite's other trainer
    modules hold them (several workers share the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("space", list(SPACES))
def test_sample_trial_draws_the_jax_package_trials(space):
    ours, theirs = tune.SearchSpace(**SPACES[space]), jax_tune.SearchSpace(**SPACES[space])
    for seed in range(4):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(16):
            assert tune.sample_trial(ours, rng) == jax_tune.sample_trial(theirs, jrng)


@pytest.mark.parametrize("scheduler", [None, "step", "cosine"])
def test_apply_trial_builds_the_jax_package_config(scheduler):
    params = {"lr": 3e-4, "weight_decay": 1e-2, "loss_type": "dice_focal", "focal_loss_gamma": 3.0,
              "weighted_loss": True, "lr_scheduler_type": scheduler, "warmup_epochs": 1, "random_crop_size": 128,
              "batch_size": 8}
    base = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    jbase = jax_cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    for epochs in (None, 1, 4):
        ours = tune.apply_trial(base, params, epochs_per_trial=epochs)
        assert dataclasses.asdict(ours) == dataclasses.asdict(jax_tune.apply_trial(jbase, params, epochs_per_trial=epochs))
    assert base.train.lr != params["lr"]  # a copy: the base config is untouched


def test_asha_rungs_equal_the_jax_package_rungs():
    for max_epochs in range(1, 20):
        for eta in (2, 3, 4):
            assert tune.asha_rungs(max_epochs, eta) == jax_tune.asha_rungs(max_epochs, eta)
    assert tune.asha_rungs(8, eta=2) == [1, 2, 4, 8]


class FakeTrial:
    """optuna's suggest API, drawn from a numpy generator."""

    def __init__(self, number, rng):
        self.number = number
        self._rng = rng
        self.names = []

    def suggest_float(self, name, lo, hi, log=False):
        self.names.append(name)
        return float(np.exp(self._rng.uniform(np.log(lo), np.log(hi)))) if log else lo

    def suggest_categorical(self, name, choices):
        self.names.append(name)
        return choices[self._rng.integers(len(choices))]


@pytest.mark.parametrize("space", list(SPACES))
def test_optuna_sampling_equals_the_jax_package(space):
    ours, theirs = FakeTrial(0, np.random.default_rng(3)), FakeTrial(0, np.random.default_rng(3))
    assert tune._sample_trial_optuna(ours, tune.SearchSpace(**SPACES[space])) == \
        jax_tune._sample_trial_optuna(theirs, jax_tune.SearchSpace(**SPACES[space]))
    assert ours.names == theirs.names


def _stub_trainers(monkeypatch, losses):
    """Both packages' trainers replaced by stubs whose trial k reports
    validation loss losses[k] every epoch."""
    made = {"port": [], "jax": []}

    def stub(kind):
        class Stub:
            def __init__(self, cfg, dm, **kwargs):
                self.loss = losses[len(made[kind])]
                made[kind].append(kwargs)

            def fit(self, epochs, start_epoch=0):
                return [{"val/loss": self.loss, "val/iou": 1.0 - self.loss} for _ in range(start_epoch, epochs)]
        return Stub

    monkeypatch.setattr(trainer_mod, "SegmentationTrainer", stub("port"))
    monkeypatch.setattr(jax_trainer_mod, "SegmentationTrainer", stub("jax"))
    return made


def _outcomes(results):
    return [(r.params, r.val_loss, r.val_iou, r.pruned, r.epochs_trained, len(r.history)) for r in results]


@pytest.mark.parametrize("eta", [1, 2, 3])
def test_asha_prunes_the_jax_package_trials(monkeypatch, eta):
    losses = [0.1, 0.5, 0.9, 0.05, 0.3, 0.7, 0.2, 0.02]
    made = _stub_trainers(monkeypatch, losses)
    base = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    jbase = jax_cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    kw = dict(datamodule_factory=lambda cfg: None, n_trials=len(losses), epochs_per_trial=4, eta=eta, seed=5)
    ours = tune.tune(base, space=tune.SearchSpace(), device="cpu", **kw)
    theirs = jax_tune.tune(jbase, space=jax_tune.SearchSpace(), **kw)
    assert _outcomes(ours) == _outcomes(theirs)
    assert made["port"] == [{"device": "cpu"}] * len(losses)
    pruned = [r.pruned for r in ours]
    assert (eta > 1) == any(pruned) and pruned == sorted(pruned)  # completed trials rank first
    assert [r.val_loss for r in ours if not r.pruned] == sorted(r.val_loss for r in ours if not r.pruned)


def test_optuna_backend_drives_the_trials(monkeypatch):
    _stub_trainers(monkeypatch, [0.4, 0.2, 0.6])
    calls = {"optimize": 0}

    class FakeStudy:
        def __init__(self):
            self._rng = np.random.default_rng(0)

        def optimize(self, objective, n_trials):
            calls["optimize"] += 1
            for i in range(n_trials):
                objective(FakeTrial(i, self._rng))

    fake = types.ModuleType("optuna")
    fake.create_study = lambda direction, sampler: FakeStudy()
    fake.samplers = types.SimpleNamespace(TPESampler=lambda seed: None)
    monkeypatch.setitem(sys.modules, "optuna", fake)
    base = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    results = tune.tune(base, datamodule_factory=lambda cfg: None, n_trials=3, epochs_per_trial=1,
                        backend="optuna", device="cpu")
    assert calls["optimize"] == 1 and [r.val_loss for r in results] == [0.2, 0.4, 0.6]


def test_missing_optuna_falls_back_to_random_search(monkeypatch, caplog):
    _stub_trainers(monkeypatch, [0.4, 0.2, 0.6, 0.4, 0.2, 0.6])
    monkeypatch.setitem(sys.modules, "optuna", None)  # the import raises ImportError
    base = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    kw = dict(datamodule_factory=lambda cfg: None, n_trials=3, epochs_per_trial=1, seed=2, device="cpu")
    with caplog.at_level(logging.WARNING, logger="s2tpu_torch.train.tune"):
        fell_back = tune.tune(base, backend="optuna", **kw)
    assert "falling back to random search" in caplog.text
    assert _outcomes(fell_back) == _outcomes(tune.tune(base, backend="random", **kw))


def test_cli_type_tune_trains_trials_and_prints_the_best(fixture_dir, tmp_path, monkeypatch, capsys):
    """``--type tune`` on the CPU: two B0 trials of one epoch each, the
    trials the JAX package's sampler draws from the config's seed, a
    trainer built for each, ``tune/*`` scalars by rank, ``best_params=``."""
    from s2tpu_torch.cli.train_segmentation import main
    from s2tpu_torch.configs import paths

    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    built = []
    trainer_cls = trainer_mod.SegmentationTrainer

    class Recording(trainer_cls):
        def __init__(self, config, dm, **kwargs):
            super().__init__(config, dm, **kwargs)
            built.append((config.train.loss_type.value, config.train.lr, str(self.device), self.run_logger))

    monkeypatch.setattr(trainer_mod, "SegmentationTrainer", Recording)
    results = main(["small", "osm-multiclass", "efficientnet-unet-b0", "--type", "tune", "--n-trials", "2",
                    "--epochs-per-trial", "1", "--data-dir", str(fixture_dir), "--bs", "2", "--crop", "64",
                    "--compute-dtype", "float32", "--name", "tn", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"best_params={results[0].params}" in out
    rng = np.random.default_rng(cfg_lib.base_config("efficientnet-unet-b0").train.seed)
    drawn = [jax_tune.sample_trial(jax_tune.SearchSpace(), rng) for _ in range(2)]
    assert built == [(p["loss_type"], p["lr"], "cpu", None) for p in drawn]
    assert sorted(map(str, (r.params for r in results))) == sorted(map(str, drawn))
    assert all(np.isfinite(r.val_loss) and r.epochs_trained == 1 for r in results)
    (log,) = (tmp_path / "logs" / "runs").glob("tn_*.metrics.jsonl")
    logged = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in logged] == [0, 1]
    assert [r["tune/val_loss"] for r in logged] == [r.val_loss for r in results]
    assert all("tune/val_iou" in r and "tune/param_lr" in r for r in logged)
