"""What the metric readers share."""

from __future__ import annotations


def share(part: float | None, whole: float | None) -> float | None:
    """100 part / whole, or None where either is missing or the whole is 0."""
    if part is None or not whole:
        return None
    return 100.0 * part / whole


def roofline(summary: dict, cls: str) -> float | None:
    """A kernel class's least seconds (``work/<class>.py``) over the device
    seconds of the kernels its patterns match, in %; None where the class
    did no work or no kernel of it ran."""
    return share(summary.get("least_s", {}).get(cls), summary["class_s"].get(cls))
