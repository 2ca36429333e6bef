"""Profiling in s2tpu_torch (``train.profiling``): the counterparts of ``tests/test_profiling_eda.py:9,19`` and the MFU's FLOP count.

The FLOP count of one step is exact arithmetic on shapes: PyTorch's formula
for ``aten`` products and the port's for its attention custom ops (2 L² Dh
operations a head for each product, two forward and four backward).
"""

import json

import torch

from s2tpu_torch.ops import flash_attention as fa
from s2tpu_torch.train import profiling
from s2tpu_torch.train.profiling import StepTimer, profile_step_fn

torch.set_num_threads(2)


def test_step_timer():
    t = StepTimer(warmup=1)
    for _ in range(4):
        with t.step():
            pass
    s = t.summary()
    assert s["steps"] == 3
    assert s["mean_s"] >= 0 and s["p50_s"] >= 0


def test_profile_step_fn(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "LOG_DIR", tmp_path)
    summary = profile_step_fn(lambda x: x * 2 + 1, lambda: (torch.ones((8, 8)),), steps=5, warmup=1,
                              trace_name="toy")
    assert summary["steps"] == 4
    assert summary["min_s"] > 0
    trace = json.loads((tmp_path / "profiles" / "toy" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_step_flops_count_the_attention_ops():
    b, l, d, heads = 2, 130, 64, 2  # L on the fused route: kernels #8 / #9 (their plain versions here)
    proj = torch.nn.Linear(d, 3 * d)
    x = torch.randn(b, l, d)

    def step():
        out = fa.fused_attention_dense(proj(x), heads)
        out.sum().backward()

    linear = 2 * b * l * d * 3 * d  # one product of the projection: forward, and its weight's gradient
    attention = 2 * b * heads * l * l * (d // heads)  # one L^2 Dh product of every head
    assert profiling.count_flops(step) == 2 * linear + 6 * attention


def test_mfu_peak_table():
    assert profiling.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert profiling.peak_flops("a card the table lacks") is None
    assert profiling.mfu(989e12, 2, 4.0, peak=989e12) == 0.5
    assert profiling.mfu(1e12, 1, 1.0, peak=None) == (None if profiling.peak_flops() is None else 1e12 / profiling.peak_flops())
