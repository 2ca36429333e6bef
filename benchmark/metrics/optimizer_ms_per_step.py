"""optimizer_ms_per_step.*: device milliseconds of the ``optimizer`` kernel
class (Adam's foreach kernels) per training step of the window."""


def read(summary: dict) -> float | None:
    seconds, steps = summary["class_s"].get("optimizer"), summary.get("steps")
    return 1e3 * seconds / steps if seconds and steps else None
