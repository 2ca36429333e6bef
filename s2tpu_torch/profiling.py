"""Profiling: ``torch.profiler`` traces, and the spans and counters the port records under them.

``trace`` profiles a block (CPU, and CUDA where there is a card) and writes
its Chrome trace (open it in Perfetto or ``chrome://tracing``) under the log
directory, as the JAX package writes a ``jax.profiler`` trace, and beside it
the spans and counters the port recorded in the block.

The recorder is on exactly while a ``torch.profiler`` profiles the calling
thread, as ``torch.autograd._profiler_enabled()`` says; it has no switch of
its own. Off, :func:`span` and :func:`count` read that one flag and return.
On, a span enters ``record_function`` (so its range lies in the profiler's
trace beside the card's kernels) and keeps a record in memory: its name,
``start_ns`` and ``end_ns`` (``time.perf_counter_ns``), ``parent`` (the
index of the span it opened inside, in this thread) and ``root`` (the index
of its outermost span: every span of one request or one training window
shares it). A counter adds under the same check. Neither synchronizes the
card, reads a device value or allocates on the device, so the program runs
the same kernels and syncs with the recorder on or off.

Spans, at the layer boundaries (roots first):

- serving, ``infer/tiled.py``: ``s2tpu.serve.request`` (one
  ``tiled_predict_many`` call) and its ``upload``, ``queue``, ``capture``
  or ``stage``, ``chunks`` and ``finish``;
- training, ``train/base.py``: ``s2tpu.train.window`` and its ``draws``,
  and for each step ``begin_step`` and ``capture``, ``replay`` or
  ``eager_step``;
- data, ``data/device_corpus.py``: ``s2tpu.data.corpus`` and its
  ``materialize`` and ``upload``;
- kernels, ``ops/_build.py``: ``s2tpu.ops.build`` (one nvcc run).

Counters: ``graph_captures`` and ``graph_replays`` (``StepGraph`` and
``TiledGraph``), ``host_syncs`` (where serving's host waits for the card),
``kernel_builds`` (nvcc runs), and ``batchnorm_fused`` (each train-mode
BatchNorm call on the card, ``ops/batchnorm_act.py``; a graph replay calls
none).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from s2tpu_torch.configs.paths import LOG_DIR

_OFF = contextlib.nullcontext()
_lock = threading.Lock()  # guards _spans and _counts: spans and counts may come from several threads
_open = threading.local()  # .stack: this thread's open spans, (index, record), innermost last
_spans: list[dict] = []
_counts: dict[str, int] = {}


class _Span:
    """One span while the recorder is on: its record and its profiler range."""

    __slots__ = ("name", "record", "range")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> _Span:
        stack = _open.__dict__.setdefault("stack", [])
        parent, outer = stack[-1] if stack else (None, None)
        with _lock:
            index = len(_spans)
            if parent is not None and (parent >= index or _spans[parent] is not outer):
                parent = None  # opened before a clear(): this span starts a new root
            self.record = {"name": self.name, "start_ns": time.perf_counter_ns(), "end_ns": None,
                           "parent": parent, "root": index if parent is None else outer["root"]}
            _spans.append(self.record)
        stack.append((index, self.record))
        self.range = record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.range.__exit__(*exc)
        self.record["end_ns"] = time.perf_counter_ns()
        _open.stack.pop()


def span(name: str) -> contextlib.AbstractContextManager:
    """A context manager that spans its block as ``name`` while a profiler
    runs, and does nothing otherwise."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if not _profiler_enabled():
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def records() -> dict:
    """A snapshot: ``spans`` (each record, in the order they opened; a span
    still open has ``end_ns`` None) and ``counts`` (counter name -> total)."""
    with _lock:
        return {"spans": [dict(r) for r in _spans], "counts": dict(_counts)}


def clear() -> None:
    """Empty the recorder: every span and counter."""
    with _lock:
        _spans.clear()
        _counts.clear()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(name: str = "trace", log_dir: str | Path | None = None):
    """Profile a block (CPU, and CUDA where there is a card) and write its
    Chrome trace to ``<log_dir>/trace.json`` and the recorder's spans and
    counters of the block to ``<log_dir>/spans.json`` (default directory:
    ``logs/profiles/<name>``); the recorder is cleared on entry. Yields the
    directory."""
    out = Path(log_dir) if log_dir is not None else LOG_DIR / "profiles" / name
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield out
        _sync()
    prof.export_chrome_trace(str(out / "trace.json"))
    (out / "spans.json").write_text(json.dumps(records()))
