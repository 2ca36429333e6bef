"""depthwise_roofline.*: the ``depthwise`` class's least time
(``work/depthwise.py``) over the device time of its kernels, %."""

from benchmark.lib.readers import roofline


def read(summary: dict) -> float | None:
    return roofline(summary, "depthwise")
