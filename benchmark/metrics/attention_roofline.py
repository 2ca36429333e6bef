"""attention_roofline.*: the ``attention`` class's least time
(``work/attention.py``) over the device time of its kernels, %."""

from benchmark.lib.readers import roofline


def read(summary: dict) -> float | None:
    return roofline(summary, "attention")
