"""Kernel class ``attention``: fused multi-head attention of a ViT over
sequences of 128 tokens or more (shorter ones are not this class's work:
the configuration's route computes them as plain products).

Per attention of B x H heads over L tokens of Dh at the compute dtype's
width e, with size = B L H Dh e: the forward reads q, k, v and writes o,
4 size bytes, and computes two L x L x Dh products, 4 B H L^2 Dh
operations; the backward reads q, k, v, o and do and writes dq, dk, dv,
8 size bytes, and five such products, 10 B H L^2 Dh operations. The
products run on the tensor cores at the bf16 rate.
"""

from __future__ import annotations

from benchmark.lib.peaks import BF16_FLOPS_PER_S, DTYPE_BYTES, least_seconds

MIN_TOKENS = 128


def least_seconds_per_call(model, call: dict) -> float | None:
    """The class's least seconds in one call of ``model`` (``call``: batch,
    training, dtype, mask_ratio); None where the model has no attention."""
    shapes = getattr(model, "attention_shapes", None)
    if shapes is None:
        return None
    e = DTYPE_BYTES[call["dtype"]]
    total = 0.0
    for b, l, h, dh in shapes(call["batch"], call.get("mask_ratio", 0.0)):
        if l < MIN_TOKENS:
            continue
        size, product = b * l * h * dh * e, 2 * b * h * l * l * dh
        total += least_seconds(4 * size, 2 * product, BF16_FLOPS_PER_S)
        if call["training"]:
            total += least_seconds(8 * size, 5 * product, BF16_FLOPS_PER_S)
    return total
