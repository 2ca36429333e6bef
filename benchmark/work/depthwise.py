"""Kernel class ``depthwise``: the stride-1 depthwise convolutions of an
EfficientNet-UNet (stride 2 is not this class's work).

Per layer of k x k taps over B x H x H x C elements at the compute dtype's
width e: the forward reads x and the filter and writes y, (2 B H^2 C + k^2 C) e
bytes and 2 k^2 B H^2 C operations; in training the input gradient does the
same, and the filter gradient reads x and dy and writes an f32 filter, 2 B
H^2 C e + 4 k^2 C bytes and 2 k^2 B H^2 C operations. The operations run on
the CUDA cores (no matrix unit takes a depthwise product), at the float32 rate.
"""

from __future__ import annotations

from benchmark.lib.peaks import DTYPE_BYTES, F32_FLOPS_PER_S, least_seconds


def least_seconds_per_call(model, call: dict) -> float | None:
    """The class's least seconds in one call of ``model`` (``call``: batch,
    size, training, dtype); None where the model has no such layer."""
    layers = getattr(model, "stride1_depthwise", None)
    if layers is None:
        return None
    e, training = DTYPE_BYTES[call["dtype"]], call["training"]
    total = 0.0
    for k, c, h in layers(call["size"]):
        n = call["batch"] * h * h * c
        flops = 2 * k * k * n
        passes = [((2 * n + k * k * c) * e, flops)]
        if training:
            passes += [((2 * n + k * k * c) * e, flops), (2 * n * e + 4 * k * k * c, flops)]
        total += sum(least_seconds(b, f, F32_FLOPS_PER_S) for b, f in passes)
    return total
