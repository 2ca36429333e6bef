"""mfu.*: the FLOPs of the window's work (counted on the plain reference
at the cell's shapes: forward and backward of every step, or the forward of
every tile served), over the window, over the card's bf16 dense peak, %."""

from benchmark.lib.peaks import BF16_FLOPS_PER_S
from benchmark.lib.readers import share


def read(summary: dict) -> float | None:
    return share(summary.get("flops", 0.0) / summary["window_s"], BF16_FLOPS_PER_S) or None
