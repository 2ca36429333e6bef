"""graph_captures.*: CUDA graphs the program captured in the traced window
(its ``graph_captures`` counter: each ``StepGraph`` and ``TiledGraph``
construction); None where the recorder holds no root span of the cell's
kind (a training window, or a serving request)."""

from benchmark.metrics import _program as program


def read(summary: dict, records: dict | None = None) -> float | None:
    records = program.snapshot(records)
    root = program.REQUEST if "requests" in summary else program.WINDOW  # serving summaries count requests
    if not program.roots(records, root):
        return None
    return float(records["counts"].get("graph_captures", 0))
