"""The precision the plain reference computes in.

``F32`` is the reference itself: every product in float32, with TF32 off
(:func:`exact_f32`), so a float32 matrix product is not rounded to TF32's
10-bit mantissa on the card. ``FP8`` is the control: the configurations
state bfloat16 compute, and the step below it is fp8 (e4m3), so every
operand of a convolution or a dense product is rounded to e4m3 with a
per-tensor scale (amax over 448, the format's largest finite value) before
a float32 product. The rounding is straight-through: the gradient passes
the cast unchanged, as a fake-quantized training step has it.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


class Precision:
    """How a reference layer treats the operands of its products."""

    name = "f32"

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x


class FP8(Precision):
    """Operands rounded to fp8 e4m3 at a per-tensor scale, straight-through."""

    name = "fp8"

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x.detach())


F32 = Precision()
PRECISIONS = {"f32": F32, "fp8": FP8()}


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matrix products and cuDNN convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
