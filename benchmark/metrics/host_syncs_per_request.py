"""host_syncs_per_request.*: the program's ``host_syncs`` counter (each
point of the serving path where the host waits for the card) over the
window's request spans."""

from benchmark.metrics import _program as program


def read(summary: dict, records: dict | None = None) -> float | None:
    records = program.snapshot(records)
    requests = program.roots(records, program.REQUEST)
    return records["counts"].get("host_syncs", 0) / len(requests) if requests else None
