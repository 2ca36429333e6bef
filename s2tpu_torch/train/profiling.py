"""Profiling: ``torch.profiler`` traces, step timing and a FLOP-count MFU (the port of ``s2tpu/train/profiling.py``).

``trace`` writes a Chrome trace (open it in Perfetto or
``chrome://tracing``) under the log directory, as the JAX package writes a
``jax.profiler`` trace. ``StepTimer`` synchronizes the card before it reads
the clock, as JAX blocks on a step's output. The MFU counts one step's
operations with ``FlopCounterMode`` (PyTorch's formulas for its own ops,
and the port's for its attention and depthwise custom ops) in place of
XLA's cost analysis of a lowered program (``mfu_from_lowered``).
"""

from __future__ import annotations

import contextlib
import time
import typing
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from s2tpu_torch.configs.paths import LOG_DIR

# Dense bf16 tensor-core peak by card name: NVIDIA's H100 SXM data sheet,
# 989 TFLOP/s without sparsity (at the SXM part's 700 W power limit).
PEAK_BF16_FLOPS: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(name: str = "trace", log_dir: str | Path | None = None):
    """Profile a block of steps (CPU, and CUDA where there is a card) and
    write its Chrome trace to ``<log_dir>/trace.json`` (default directory:
    ``logs/profiles/<name>``); yields the directory."""
    out = Path(log_dir) if log_dir is not None else LOG_DIR / "profiles" / name
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield out
        _sync()
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Step timing with the card synchronized at both ends of a step, the
    first ``warmup`` steps discarded, and percentiles."""

    def __init__(self, warmup: int = 2) -> None:
        self.warmup = warmup
        self.times: list[float] = []
        self._count = 0

    @contextlib.contextmanager
    def step(self, sync: typing.Any = None):  # noqa: ARG002 (JAX's signature: the card is synchronized anyway)
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self._count += 1
        if self._count > self.warmup:
            self.times.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[int(n * 0.9)],
            "min_s": ts[0],
        }


def profile_step_fn(
    step_fn: typing.Callable,
    args_fn: typing.Callable[[], tuple],
    steps: int = 20,
    warmup: int = 3,
    trace_name: str | None = None,
) -> dict:
    """Time a step function; optionally trace 3 more steps (``trace``)."""
    timer = StepTimer(warmup=warmup)
    out = None
    for _ in range(steps):
        with timer.step(sync=out):
            out = step_fn(*args_fn())
    summary = timer.summary()
    if trace_name is not None:
        with trace(trace_name):
            for _ in range(3):
                step_fn(*args_fn())
    return summary


def count_flops(fn: typing.Callable, *args, **kwargs) -> int:
    """Operations of one call of ``fn`` (forward and, if ``fn`` runs one,
    backward) by ``FlopCounterMode``; run it eagerly, not as a graph replay."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def peak_flops(device_name: str | None = None) -> float | None:
    """The dense bf16 peak of the card named ``device_name`` (default: card
    0) from :data:`PEAK_BF16_FLOPS`; None for a card the table lacks or
    without a card."""
    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    return PEAK_BF16_FLOPS.get(device_name)


def mfu(flops_per_step: float, n_steps: int, elapsed_s: float, peak: float | None = None) -> float | None:
    """Model FLOP utilization: ``flops_per_step · n_steps / elapsed_s`` over
    the peak (default: the card's, :func:`peak_flops`); None where the peak
    is not known or nothing was counted."""
    peak = peak_flops() if peak is None else peak
    if not peak or flops_per_step <= 0 or elapsed_s <= 0:
        return None
    return flops_per_step * n_steps / elapsed_s / peak
