"""corpus_build_s: seconds from the trainer's read of the corpus arrays to
the end of its construction, of which the device corpus's upload is the
last step (host clock, at set-up)."""


def read(summary: dict) -> float | None:
    return summary.get("corpus_build_s")
