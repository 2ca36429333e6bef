"""Tiny cells for the CPU tests: the real cells' configurations and mixes at
sizes a test run holds (B0 in f32 at 64^2, a two-block ViT, 112^2 segments)."""

from __future__ import annotations

import copy
import time

from benchmark.lib import spec

# Limits of the tiny cells in f32 on the CPU, where the system reads (PR 21's CPU runs): loss ~1e-6,
# grad ~6e-3 (train-mode BatchNorm at 4 rows), change ~2e-3, class 0; planted faults read 0.02-1 and more.
TRAIN_LIMITS = {"limits": {"loss_gap": 1e-3, "grad_gap": 0.05, "change_gap": 0.05}}
SERVE_LIMITS = {"limits": {"class_gap_mean": 0.001}}


def train_cell(which: str) -> spec.Cell:
    name = {"b5": "b5.train.corpus", "mae": "mae.train.t1"}[which]
    real = spec.load_cell(name)
    cfg = copy.deepcopy(real.config)
    cfg["corpus"] = {"segments": 24, "segment_size": 80}
    cfg["precision"] = "float32"
    if which == "b5":
        cfg["model"]["version"] = "b0"
        cfg["cli"] = ["small", "osm-multiclass", "efficientnet-unet-b0", "--loss-type", "focal", "--weighted-loss",
                      "--bs", "4", "--crop", "64", "--compute-dtype", "float32"]
    else:
        cfg["model"].update(img_size=64, embed_dim=64, depth=2, num_heads=2, decoder_embed_dim=32, decoder_depth=2,
                            decoder_num_heads=2)
        cfg["cli"] = ["small", "--type", "pretrain", "--from-scratch", "--compute-dtype", "float32", "--bs", "4",
                      "--crop", "64", "--wandb"]
    cfg["recipe"].update(batch=4, crop=64)
    traffic = {**real.traffic, "steps_per_window": 2, "pool": 8, "trace_windows": 2}
    return spec.Cell(name=f"tiny.{name}", chips=1, config=cfg, traffic=traffic, limits=TRAIN_LIMITS,
                     end_to_end=real.end_to_end, per_layer=real.per_layer)


def serve_cell() -> spec.Cell:
    real = spec.load_cell("b5.serve.aoi8")
    cfg = copy.deepcopy(train_cell("b5").config)
    cfg["serve"] = {"tile": 64, "overlap": 16, "chunk": 4}
    traffic = {**real.traffic, "segments_per_request": 2, "segment_size": 112, "pool": 4, "trace_requests": 3,
               "calibration_tiles": 4}
    return spec.Cell(name="tiny.b5.serve.aoi8", chips=1, config=cfg, traffic=traffic, limits=SERVE_LIMITS,
                     end_to_end=real.end_to_end, per_layer=real.per_layer)


def execute(cell: spec.Cell, seed: int = 7, trace: bool = False) -> dict:
    """A run of ``cell`` on the CPU, past the harness's look for a card."""
    from benchmark.run import execute as run_execute

    return run_execute(cell, seed, 0.3, trace, "cpu", time.perf_counter())
