"""The traced window: ``torch.profiler`` over it, reduced to a summary.

The runner marks its own host spans with ``record_function("bench.<what>")``
(draws, the window's calls into the system, a request, ...) and the whole
traced window with ``bench.window``. :func:`summarize` reads the profiler's
raw events once:

- device intervals: every kernel, copy and set on the card (not the
  profiler's annotations), clipped to the window; ``busy_s`` is the length
  of their union, so overlapping kernels count once;
- device seconds by kernel name and by kernel class (``kernel_classes/``);
- the idle gaps of the union, each labelled by the innermost host event
  that spans its middle (one of the runner's spans, or an operation of the
  system's host code);
- the host's launch calls (kernel and graph launches, async copies and sets).

The runner adds its own counts (steps, images, requests, chunks, FLOPs and
least times) to the summary; the readers under ``metrics/`` take theirs from it.
"""

from __future__ import annotations

import contextlib
import heapq

import torch

from benchmark.lib import spec

WINDOW = "bench.window"
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
               "cudaMemcpyAsync", "cudaMemsetAsync")
TOP = 10
NAME_CHARS = 120


@contextlib.contextmanager
def traced(enabled: bool):
    """Yield a profiler over the block (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def kernel_class(name: str, classes: dict[str, list[str]]) -> str:
    for cls, frags in classes.items():
        if any(f in name for f in frags):
            return cls
    return "other"


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(prof, classes: dict[str, list[str]] | None = None) -> dict:
    classes = classes if classes is not None else spec.kernel_classes()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            if e.device_type() == torch.autograd.DeviceType.CPU:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    windows = [(s, e) for s, e, n in host if n == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = windows[0]
    by_name: dict[str, float] = {}
    spans = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        spans.append((s, e))
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    busy = merge(spans)
    by_class: dict[str, float] = {}
    for name, sec in by_name.items():
        cls = kernel_class(name, classes)
        by_class[cls] = by_class.get(cls, 0.0) + sec
    edges = [w0, *[t for iv in busy for t in iv], w1]
    gaps = heapq.nlargest(TOP, ((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)))
    window_host = [h for h in host if h[1] > w0 and h[0] < w1 and h[2] != WINDOW]
    idle = []
    for length, start in gaps:
        if length <= 0:
            continue
        mid = start + length / 2
        around = [h for h in window_host if h[0] <= mid <= h[1]]
        label = min(around, key=lambda h: h[1] - h[0])[2] if around else "no host event"
        idle.append([label[:NAME_CHARS], length / 1e9])
    top = heapq.nlargest(TOP, by_name.items(), key=lambda kv: kv[1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_s": sum(by_name.values()),
        "class_s": by_class,
        "launches": sum(1 for s, e, n in window_host if n in LAUNCH_APIS),
        "breakdown": {
            "device_ops": [[f"{kernel_class(n, classes)}: {n}"[:NAME_CHARS], sec] for n, sec in top],
            "idle_gaps": idle,
        },
    }
