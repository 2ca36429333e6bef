"""SIGTERM preemption and exact resume in s2tpu_torch's trainers, and the random draws across a resume (``tests/test_preemption.py`` on the host-streamed path).

A SIGTERM (raised for real after a train step, so the handler that ``fit``
installs is exercised) stops training at the next step boundary and writes
the model, Adam, the f32 master, the EMA, the step and the epoch's trained
batches to ``preempt/``; the same command with ``--auto-resume`` re-enters
that epoch and skips its trained prefix. The resumed run then performs the
uninterrupted run's operations on the same data in the same order on the
CPU, drop-connect and masking noise included (drawn from (seed, step,
micro-batch)), so its weights equal the uninterrupted run's: held to rtol
1e-6 and atol 1e-7, as the JAX package's test holds its own.
"""

import signal

import numpy as np
import pytest
import torch

from s2tpu_torch.checkpoint import io
from s2tpu_torch.models.prithvi_mae import PrithviConfig
from s2tpu_torch.train.mae_trainer import MAETrainer
from s2tpu_torch.train.trainer import SegmentationTrainer

SEG_ARGV = ["small", "osm-multiclass", "efficientnet-unet-b0", "--bs", "2", "--crop", "64", "--compute-dtype",
            "float32", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch CPU threads in this module: the suite runs several workers
    on one machine, where torch's default of one thread per core makes its
    workers thrash (the module's checks compare runs within one process)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _close(ours: dict, theirs: dict) -> None:
    assert sorted(ours) == sorted(theirs)
    for name, t in theirs.items():
        torch.testing.assert_close(ours[name], t, rtol=1e-6, atol=1e-7, msg=name)


def _sigterm_after_first_step(monkeypatch, cls) -> None:
    """``cls.train_step`` raises a real SIGTERM after its first call."""
    step, calls = cls.train_step, []

    def wrapped(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        calls.append(1)
        if len(calls) == 1:
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(cls, "train_step", wrapped)


@pytest.fixture()
def cli_paths(tmp_path, monkeypatch):
    from s2tpu_torch.configs import paths

    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    return tmp_path / "ckpts" / "sentinel-segmentation"


def test_train_batches_start_skips_without_changing_the_stream(fixture_dir):
    from s2tpu_torch.configs.segmentation import DatamoduleConfig, DatasetConfig
    from s2tpu_torch.data.pipeline import Datamodule

    dm = Datamodule(DatamoduleConfig(
        dataset_cfg=DatasetConfig(aoi="small", label_map="osm-multiclass", data_dir=str(fixture_dir)),
        batch_size=2, data_split=(1.0, 0.0, 0.0), random_crop_size=64,
    ))
    full, rest = list(dm.train_batches(1)), list(dm.train_batches(1, start=1))
    assert len(full) == 3 and len(rest) == 2
    for a, b in zip(full[1:], rest):
        assert np.array_equal(a.images, b.images) and np.array_equal(a.labels, b.labels)


def test_seg_sigterm_mid_epoch_then_auto_resume_equals_the_uninterrupted_run(fixture_dir, cli_paths, monkeypatch):
    """B0 with drop-connect, two micro-batches, remat, bf16 parameters and an
    EMA, one epoch of 2 steps: a SIGTERM after the first step, then the same
    command again, against one uninterrupted run."""
    from s2tpu_torch.cli.train_segmentation import main
    from s2tpu_torch.configs import segmentation as cfg_lib

    argv = [*SEG_ARGV, "--data-dir", str(fixture_dir), "--epochs", "1", "--remat", "--param-dtype", "bfloat16",
            "--ema-decay", "0.9", "--auto-resume"]
    base_config = cfg_lib.base_config

    def accumulating(*args, **kwargs):  # the CLI has no flag for it, as in s2tpu
        config = base_config(*args, **kwargs)
        config.train.grad_accum_steps = 2
        return config

    monkeypatch.setattr(cfg_lib, "base_config", accumulating)
    main([*argv, "--name", "ref"])
    with monkeypatch.context() as m:
        _sigterm_after_first_step(m, SegmentationTrainer)
        assert main([*argv, "--name", "int"]) == []  # stopped inside epoch 0
    run = cli_paths / "int_sentinel-segmentation"
    ckpt = io.CheckpointManager(run)
    assert ckpt.has_preempt() and ckpt.latest_epoch() is None
    preempted = ckpt.restore_preempt()
    assert (preempted["epoch"], preempted["batches_done"], preempted["step"]) == (0, 1, 1)
    assert preempted["master"] is not None and preempted["ema"] is not None
    history = main([*argv, "--name", "int"])
    assert [r["epoch"] for r in history] == [0] and not ckpt.has_preempt()
    ref = io.CheckpointManager(cli_paths / "ref_sentinel-segmentation").restore(0)
    resumed = ckpt.restore(0)
    assert resumed["step"] == ref["step"] == 2
    for part in ("model", "master", "ema"):
        _close(resumed[part], ref[part])


def test_resume_from_continues_the_drop_connect_stream(fixture_dir, cli_paths):
    """2 epochs in one run equal 1 epoch, then ``--resume-from`` for the
    second, with drop-connect on: the resumed run draws step 2's masks, not
    step 0's again."""
    from s2tpu_torch.cli.train_segmentation import main

    argv = [*SEG_ARGV, "--data-dir", str(fixture_dir)]
    main([*argv, "--epochs", "2", "--name", "whole"])
    main([*argv, "--epochs", "1", "--name", "split"])
    (split,) = cli_paths.glob("split_*")
    main([*argv, "--epochs", "2", "--resume-from", str(split)])
    (whole,) = cli_paths.glob("whole_*")
    ref, resumed = io.CheckpointManager(whole).restore(1), io.CheckpointManager(split).restore(1)
    assert resumed["step"] == ref["step"] == 4
    _close(resumed["model"], ref["model"])


def test_mae_sigterm_mid_epoch_then_resume_equals_the_uninterrupted_run(fixture_dir, tmp_path, monkeypatch):
    """A tiny Prithvi MAE with two micro-batches, remat, bf16 parameters and
    an EMA, one epoch of 3 steps: a SIGTERM after the first, then
    ``resume_from_checkpoint`` and ``fit`` again."""
    from s2tpu_torch.configs.segmentation import DatamoduleConfig, DatasetConfig
    from s2tpu_torch.data.dataset import TiffSource
    from s2tpu_torch.data.pipeline import Datamodule
    from tests.test_torch_mae_trainer import TINY, _configs

    def build(ckpt_dir):
        _, c = _configs(fixture_dir, 32, 2)
        c.train.grad_accum_steps, c.train.remat, c.train.param_dtype, c.train.ema_decay = 2, True, "bfloat16", 0.9
        dm = Datamodule(  # all six segments for training: 3 steps
            DatamoduleConfig(
                dataset_cfg=DatasetConfig(aoi="small", label_map="osm-multiclass", data_dir=str(fixture_dir)),
                batch_size=2, data_split=(1.0, 0.0, 0.0), random_crop_size=32, augment=False,
            ),
            source=TiffSource("small", "osm-multiclass", data_dir=fixture_dir, require_labels=False),
        )
        return MAETrainer(c, dm, model_config=PrithviConfig(**TINY), checkpoint_manager=io.CheckpointManager(ckpt_dir),
                          device="cpu")

    ref = build(tmp_path / "ref")
    ref.fit(epochs=1)
    assert ref.step == 3
    with monkeypatch.context() as m:
        _sigterm_after_first_step(m, MAETrainer)
        t = build(tmp_path / "int")
        assert t.fit(epochs=1) == [] and t.step == 1 and t.ckpt.has_preempt()
    r = build(tmp_path / "int")
    assert r.resume_from_checkpoint() == 0 and r.step == 1
    r.fit(epochs=1)
    assert r.step == 3 and not r.ckpt.has_preempt()
    _close(dict(r.model.named_parameters()), dict(ref.model.named_parameters()))
    _close(r.master.master, ref.master.master)
    _close(r.ema.ema, ref.ema.ema)
