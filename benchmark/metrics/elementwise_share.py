"""elementwise_share.*: device seconds of the ``elementwise`` kernel class
(elementwise passes, casts, normalizations and reductions) over all
device seconds of the window, %."""

from benchmark.lib.readers import share


def read(summary: dict) -> float | None:
    return share(summary["class_s"].get("elementwise"), summary["device_s"])
