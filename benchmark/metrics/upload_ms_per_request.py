"""upload_ms_per_request.*: the mean over the window's requests of their
``s2tpu.serve.upload`` span (the raw segments from the host array to the
card), ms, from the program's recorder."""

from benchmark.metrics import _program as program


def read(summary: dict, records: dict | None = None) -> float | None:
    records = program.snapshot(records)
    spans = [program.part(records, r, "s2tpu.serve.upload") for r in program.roots(records, program.REQUEST)]
    return program.mean_ms([s["end_ns"] - s["start_ns"] for s in spans if s is not None and s["end_ns"]])
