"""A run of each tiny cell on the CPU, past the harness's look for a card:
sound, ``correct`` is true; with the timed path broken underneath, once for
each fault the cell can have, ``correct`` comes out false. The traced path
runs and reads its metrics."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.tests import tiny

torch.set_num_threads(2)


@pytest.mark.parametrize("which", ["b5", "mae", "serve"])
def test_sound_run_is_correct(which):
    cell = tiny.serve_cell() if which == "serve" else tiny.train_cell(which)
    result = tiny.execute(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] > 0
    assert {m["name"] for m in cell.end_to_end} == set(result["metrics"])


@pytest.mark.parametrize("which", ["b5", "mae"])
def test_traced_run_reads_its_metrics(which):
    result = tiny.execute(tiny.train_cell(which), trace=True)
    assert result["correct"] and "corpus_build_s" in result["metrics"]
    assert result["device"]["window_s"] > 0 and set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def unchanged_state(monkeypatch):
    from s2tpu_torch.train.base import TrainerBase

    monkeypatch.setattr(TrainerBase, "_update", lambda self, named, grads, accum, watch: {})


def half_batch(monkeypatch):
    from s2tpu_torch.train.mae_trainer import MAETrainer
    from s2tpu_torch.train.trainer import SegmentationTrainer

    def seg_step(self, row):
        images, labels = self.corpus.gather(row[0], row[1], row[2], self.config.datamodule.random_crop_size)
        half = images.shape[0] // 2
        m = self._step(images[:half], labels[:half])
        self._add_to_sums(m)
        return m

    def mae_step(self, row):
        images, _ = self.corpus.gather(row[0], row[1], row[2], self.config.datamodule.random_crop_size)
        m = self._step(images[: images.shape[0] // 2], flips=self.config.datamodule.augment)
        self._add_to_sums(m)
        return m

    monkeypatch.setattr(SegmentationTrainer, "_corpus_step", seg_step)
    monkeypatch.setattr(MAETrainer, "_corpus_step", mae_step)


@pytest.mark.parametrize("which", ["b5", "mae"])
@pytest.mark.parametrize("fault", [unchanged_state, half_batch], ids=["unchanged_state", "half_batch"])
def test_training_fault_is_not_correct(monkeypatch, which, fault):
    fault(monkeypatch)
    assert not tiny.execute(tiny.train_cell(which))["correct"]


def altered_answer(monkeypatch):
    from s2tpu_torch.infer import tiled

    real = tiled.tiled_predict_many

    def altered(predict, images, num_classes, *args, **kwargs):
        maps, logits = real(predict, images, num_classes, *args, **kwargs)
        maps = maps.copy()
        maps[0] = (maps[0] + 1) % num_classes
        return maps, logits

    monkeypatch.setattr(tiled, "tiled_predict_many", altered)


def half_chunk(monkeypatch):
    from s2tpu_torch.infer.tiled import ChunkProgram

    real = ChunkProgram.load

    def load(self, rows, valid):
        real(self, rows, valid * (torch.arange(valid.shape[0]) < valid.shape[0] // 2).to(valid))

    monkeypatch.setattr(ChunkProgram, "load", load)


@pytest.mark.parametrize("fault", [altered_answer, half_chunk], ids=["altered_answer", "half_chunk"])
def test_serving_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = tiny.execute(tiny.serve_cell())
    assert not result["correct"] and np.isfinite(result["checks"]["class_gap_mean"]["value"])
