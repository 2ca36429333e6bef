"""The control comes out as not correct: the reference computed one
precision below the configuration's (fp8 for its bf16 compute) in the
system's place for training, and the system's own int8 serving path for
serving. On the CPU at the tiny cells' size against their limits; on the
card (``cuda``) at each cell's own size against its committed limits."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import calibrate
from benchmark.lib import checks, spec
from benchmark.lib.context import Context
from benchmark.tests import tiny

torch.set_num_threads(2)


def readings(cell: spec.Cell, device: str, seed: int) -> dict:
    ctx = Context(cell=cell, seed=seed, seconds=0.0, trace=False, device=device, t0=time.perf_counter())
    return (calibrate.training_readings if cell.kind == "train_corpus" else calibrate.serving_readings)(ctx)


def passes(numbers: dict, cell: spec.Cell) -> bool:
    return checks.all_within(checks.within(numbers, cell.limits))


@pytest.mark.parametrize("which", ["b5", "mae", "serve"])
def test_control_is_not_correct_on_the_cpu(which):
    cell = tiny.serve_cell() if which == "serve" else tiny.train_cell(which)
    r = readings(cell, "cpu", 11)
    control = r["control_int8"] if which == "serve" else r["control_fp8"]
    assert passes(r["program"], cell) and not passes(control, cell), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["b5.train.corpus", "mae.train.t1", "b5.serve.aoi8"])
def test_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    c = spec.load_cell(cell)
    r = readings(c, "cuda", 2**31 + 101)
    control = r.get("control_int8") or r["control_fp8"]
    assert passes(r["program"], c) and not passes(control, c), r
