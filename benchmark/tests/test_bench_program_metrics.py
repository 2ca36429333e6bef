"""The readers of the program's own spans and counters (``metrics/upload_ms_per_request.py``,
``lead_ms_per_request.py``, ``host_syncs_per_request.py``, ``graph_captures.py``) against a
hand-made snapshot of ``s2tpu_torch.profiling.records()``, and against the recorder itself."""

from __future__ import annotations

import pytest
import torch

from benchmark.lib import spec

MS = 1_000_000  # ns


def _span(name: str, start_ms: float, end_ms: float | None, parent: int | None, root: int) -> dict:
    return {"name": name, "start_ns": int(start_ms * MS), "end_ns": None if end_ms is None else int(end_ms * MS),
            "parent": parent, "root": root}


def _serving() -> dict:
    """Two requests of 70 and 80 ms: uploads of 4 and 6 ms, chunks from 7 and
    9 ms after their request's start; 8 host syncs; a third request still open."""
    spans = []
    for start, upload, lead, length in ((0.0, 4.0, 7.0, 70.0), (100.0, 6.0, 9.0, 80.0)):
        root = len(spans)
        spans += [_span("s2tpu.serve.request", start, start + length, None, root),
                  _span("s2tpu.serve.upload", start + 0.5, start + 0.5 + upload, root, root),
                  _span("s2tpu.serve.queue", start + 5.0, start + 6.0, root, root),
                  _span("s2tpu.serve.stage", start + 6.0, start + lead, root, root),
                  _span("s2tpu.serve.chunks", start + lead, start + 60.0, root, root),
                  _span("s2tpu.serve.finish", start + 60.0, start + length, root, root)]
    spans.append(_span("s2tpu.serve.request", 200.0, None, None, len(spans)))
    return {"spans": spans, "counts": {"host_syncs": 8, "graph_replays": 18}}


def _training(captures: int | None) -> dict:
    spans = [_span("s2tpu.train.window", 0.0, 500.0, None, 0), _span("s2tpu.train.draws", 0.0, 1.0, 0, 0),
             _span("s2tpu.train.window", 500.0, 1000.0, None, 2)]
    return {"spans": spans, "counts": {} if captures is None else {"graph_captures": captures}}


def _read(metric: str, summary: dict, records: dict) -> float | None:
    return spec.reader(metric).read(summary, records)


SERVE, TRAIN = {"requests": 2}, {"steps": 8}


def test_serving_readers_read_closed_requests():
    records = _serving()
    assert _read("upload_ms_per_request.serve", SERVE, records) == pytest.approx(5.0)
    assert _read("lead_ms_per_request.serve", SERVE, records) == pytest.approx(8.0)
    assert _read("host_syncs_per_request.serve", SERVE, records) == 4.0
    assert _read("graph_captures.serve", SERVE, records) == 0.0


@pytest.mark.parametrize("captures", [None, 0, 1])
def test_graph_captures_reads_the_counter_of_the_cells_kind(captures):
    records = _training(captures)
    assert _read("graph_captures.train", TRAIN, records) == float(captures or 0)
    assert _read("graph_captures.serve", SERVE, records) is None  # no request span: missing, not 0


@pytest.mark.parametrize("metric", ["upload_ms_per_request.serve", "lead_ms_per_request.serve",
                                    "host_syncs_per_request.serve", "graph_captures.serve", "graph_captures.train"])
def test_no_root_span_reads_as_missing(metric):
    summary = SERVE if metric.endswith(".serve") else TRAIN
    assert _read(metric, summary, {"spans": [], "counts": {"host_syncs": 3, "graph_captures": 1}}) is None
    open_only = {"spans": [_span("s2tpu.serve.request" if summary is SERVE else "s2tpu.train.window", 0.0, None,
                                 None, 0)], "counts": {}}
    assert _read(metric, summary, open_only) is None


def test_the_readers_read_the_recorder_of_a_profiled_call():
    """Without a snapshot given, the readers read the recorder: a profiled
    serving call on the CPU gives one request with its upload and chunks."""
    from s2tpu_torch import profiling
    from s2tpu_torch.infer.tiled import tiled_predict_many

    class Predict:
        device = torch.device("cpu")

        def __call__(self, tiles: torch.Tensor) -> torch.Tensor:
            return tiles.float().mean(dim=-1, keepdim=True).repeat(1, 1, 1, 2)

    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tiled_predict_many(Predict(), torch.zeros((1, 40, 40, 3)), 2, tile=32, overlap=8, batch_size=2, graph=False)
    assert spec.reader("upload_ms_per_request.serve").read(SERVE) > 0
    assert spec.reader("lead_ms_per_request.serve").read(SERVE) > 0
    assert spec.reader("host_syncs_per_request.serve").read(SERVE) == 0.0  # the CPU path waits for no card
    assert spec.reader("graph_captures.serve").read(SERVE) == 0.0
    assert spec.reader("graph_captures.train").read(TRAIN) is None
    profiling.clear()
