"""host_launches_per_chunk.*: the host's launch calls (kernel and graph
launches, async copies and sets) in the traced window, per tile chunk served."""


def read(summary: dict) -> float | None:
    chunks = summary.get("chunks")
    return summary["launches"] / chunks if chunks else None
