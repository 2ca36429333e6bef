"""What the readers of the program's own spans and counters share.

The system records them only while a profiler runs (``s2tpu_torch.profiling``),
and the runners' profiler runs only around ``bench.window``, so the recorder
holds the traced window's spans and counts. A program without the recorder
(no ``s2tpu_torch.profiling``), or one that recorded no root span of the
cell's kind, reads as missing (None), never as 0.
"""

from __future__ import annotations

REQUEST = "s2tpu.serve.request"  # the root span of one serving call
WINDOW = "s2tpu.train.window"  # the root span of one training window


def snapshot(records: dict | None = None) -> dict | None:
    """``records`` if given, else the recorder's snapshot (None where the
    program has no recorder)."""
    if records is not None:
        return records
    try:
        from s2tpu_torch import profiling
    except ImportError:
        return None
    return profiling.records()


def roots(records: dict | None, name: str) -> list[int]:
    """The indices of the closed root spans named ``name``."""
    if records is None:
        return []
    return [i for i, s in enumerate(records["spans"])
            if s["parent"] is None and s["name"] == name and s["end_ns"] is not None]


def part(records: dict, root: int, name: str) -> dict | None:
    """The first span named ``name`` under the root span ``root``."""
    return next((s for s in records["spans"] if s["root"] == root and s["name"] == name), None)


def mean_ms(values: list[float]) -> float | None:
    return sum(values) / len(values) / 1e6 if values else None
