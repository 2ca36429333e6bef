"""lead_ms_per_request.*: the mean over the window's requests of the time
from the request's start to the start of its ``s2tpu.serve.chunks`` span,
ms: how long the host works on a request (upload, queue, staging) before
the card has any of its chunks to run; from the program's recorder."""

from benchmark.metrics import _program as program


def read(summary: dict, records: dict | None = None) -> float | None:
    records = program.snapshot(records)
    leads = []
    for r in program.roots(records, program.REQUEST):
        chunks = program.part(records, r, "s2tpu.serve.chunks")
        if chunks is not None:
            leads.append(chunks["start_ns"] - records["spans"][r]["start_ns"])
    return program.mean_ms(leads)
