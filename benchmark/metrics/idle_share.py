"""idle_share.*: the share of the traced window in which no kernel, copy or
set ran on the card (1 - the union of their intervals over the window), %."""

from benchmark.lib.readers import share


def read(summary: dict) -> float | None:
    return share(summary["window_s"] - summary["busy_s"], summary["window_s"])
