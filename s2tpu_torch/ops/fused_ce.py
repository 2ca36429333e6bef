"""Fused per-pixel cross-entropy / focal loss: hand-written CUDA kernels for both passes.

The port of ``s2tpu/ops/fused_ce.py``. One pass over the (..., K) logits
computes, per pixel, the log-sum-exp, the label logit, the class-weight
lookup, the ignore-index mask and, in focal mode, the focal modulation; it
returns the per-pixel loss and weight without a log-softmax in memory
(``csrc/fused_ce.cu``, replacing the TPU kernel ``_fwd_kernel``). The
backward pass computes ``g * scale * (softmax - onehot)`` from the logits
again (replacing ``_bwd_kernel``). The reductions to a scalar loss stay
outside the kernels, in torch, as in the JAX package.

Logits are f32 in the NHWC layout the model emits, labels int32. The JAX
kernels' transpose to (K, N), a TPU lane layout, has no counterpart here.

Both kernels are bound by bytes (~10K flops per pixel against 4K + 12 or 8K
+ 8 bytes): one thread per pixel loads its K contiguous logits as 16-byte
vectors where K allows, keeps them in registers and writes each output
once; rows past N are masked in the kernel rather than padded.

Each pass is a ``torch.library`` custom op (``s2tpu_torch::fused_ce_forward``,
``s2tpu_torch::fused_ce_backward``): its CUDA implementation launches the
kernel, its CPU implementation is the plain version, and a fake version
gives the output shapes.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernels (forward #3, backward #4); a run sets them to
# 0 and reads them. Only the CUDA branches of the wrappers add to them.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

SOURCES = ["fused_ce.cu"]
MAX_CLASSES = 32  # the kernels keep a pixel's K logits in registers


def _check(logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor) -> tuple[int, int]:
    """-> (N pixels, K classes); raises on what the kernels do not take."""
    if logits.dim() < 1 or labels.shape != logits.shape[:-1]:
        raise ValueError(f"expected logits (..., K) and labels (...), got {tuple(logits.shape)} and {tuple(labels.shape)}")
    k = logits.shape[-1]
    if not 1 <= k <= MAX_CLASSES:
        raise ValueError(f"{k} classes; the kernels take 1 to {MAX_CLASSES}")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if class_weights.shape != (k,) or class_weights.dtype != torch.float32:
        raise ValueError(f"class_weights must be ({k},) float32, got {tuple(class_weights.shape)} {class_weights.dtype}")
    if not (labels.device == logits.device == class_weights.device):
        raise ValueError("logits, labels and class_weights must share a device")
    return labels.numel(), k


def _common_reference(logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor):
    """(N, K) logits -> onehot, lse, picked, w, each as the kernels compute them."""
    k = logits.shape[-1]
    onehot = (torch.arange(k, device=logits.device) == labels[:, None].long()).to(logits.dtype)
    m = logits.max(dim=-1).values
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    picked = (logits * onehot).sum(dim=-1)
    w = (onehot * class_weights.to(logits.dtype)).sum(dim=-1)
    return onehot, lse, picked, w


def _valid_reference(labels: torch.Tensor, ignore_index: int | None) -> torch.Tensor:
    """The ignore mask, applied as a select (``torch.where``), not a product:
    the JAX kernels multiply by a 0/1 mask, which XLA rewrites into a
    select, so an ignored pixel's NaN (the (1-pt)^(gamma-1) factor at pt = 1
    when gamma < 1) never reaches its gradient there either."""
    if ignore_index is None:
        return torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    return labels != ignore_index


def fused_ce_forward_reference(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
    ignore_index: int | None = None, gamma: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward on (N, K) logits and (N,) labels -> (loss, weight),
    the formula of ``s2tpu/ops/fused_ce.py::_fwd_kernel`` (``:45-62``) in the
    kernel's order."""
    _, lse, picked, w = _common_reference(logits, labels, class_weights)
    ce = lse - picked
    valid = _valid_reference(labels, ignore_index)
    if gamma is not None:
        ce_v = torch.where(valid, ce, 0.0)  # ignored pixels have ce = 0 before the modulation
        pt = torch.exp(-ce_v)
        return w * (1.0 - pt) ** gamma * ce_v, valid.to(logits.dtype)
    return torch.where(valid, ce * w, 0.0), torch.where(valid, w, 0.0)


def fused_ce_backward_reference(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor, g: torch.Tensor,
    ignore_index: int | None = None, gamma: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch backward -> (N, K) ``g * scale * (softmax - onehot)``,
    the formula of ``s2tpu/ops/fused_ce.py::_bwd_kernel`` (``:65-85``)."""
    onehot, lse, picked, w = _common_reference(logits, labels, class_weights)
    valid = _valid_reference(labels, ignore_index)
    if gamma is not None:
        ce = lse - picked
        pt = torch.exp(-ce)
        one_minus = 1.0 - pt
        # d/d(ce) [ w * (1-pt)^gamma * ce ], pt = exp(-ce)
        scale = torch.where(valid, w * (one_minus**gamma + gamma * one_minus ** (gamma - 1.0) * pt * ce), 0.0)
    else:
        scale = torch.where(valid, w, 0.0)
    return (g * scale)[:, None] * (torch.exp(logits - lse[:, None]) - onehot)


_kernel_fns: dict[str, object] = {}


def _kernel(name: str):
    """The built kernel's C entry point ``s2_fused_ce_<name>`` (nvcc at first use)."""
    fn = _kernel_fns.get(name)
    if fn is None:
        from s2tpu_torch.ops._build import load_library

        fn = getattr(load_library("fused_ce", SOURCES), f"s2_fused_ce_{name}")
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _kernel_fns[name] = fn
    return fn


def _mode(ignore_index: int | None, gamma: float | None) -> list:
    """The kernels' (has_ignore, ignore_index, focal, gamma) arguments."""
    return [int(ignore_index is not None), int(ignore_index or 0), int(gamma is not None), float(gamma or 0.0)]


@torch.library.custom_op("s2tpu_torch::fused_ce_forward", mutates_args=(), device_types="cpu")
def _forward_op(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
    ignore_index: int | None, gamma: float | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    return fused_ce_forward_reference(logits, labels, class_weights, ignore_index, gamma)


@_forward_op.register_kernel("cuda")
def _forward_cuda(logits, labels, class_weights, ignore_index, gamma):
    global FWD_LAUNCHES
    n, k = logits.shape
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    weight = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:
        return loss, weight
    cw = class_weights.contiguous()
    err = _kernel("fwd")(
        logits.data_ptr(), labels.data_ptr(), cw.data_ptr(), loss.data_ptr(), weight.data_ptr(), n, k,
        *_mode(ignore_index, gamma), logits.device.index, torch.cuda.current_stream(logits.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_ce forward kernel launch failed with CUDA error {err}")
    FWD_LAUNCHES += 1
    return loss, weight


@_forward_op.register_fake
def _forward_fake(logits, labels, class_weights, ignore_index, gamma):
    n = logits.shape[0]
    return logits.new_empty(n, dtype=torch.float32), logits.new_empty(n, dtype=torch.float32)


@torch.library.custom_op("s2tpu_torch::fused_ce_backward", mutates_args=(), device_types="cpu")
def _backward_op(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor, g: torch.Tensor,
    ignore_index: int | None, gamma: float | None,
) -> torch.Tensor:
    return fused_ce_backward_reference(logits, labels, class_weights, g, ignore_index, gamma)


@_backward_op.register_kernel("cuda")
def _backward_cuda(logits, labels, class_weights, g, ignore_index, gamma):
    global BWD_LAUNCHES
    n, k = logits.shape
    dlogits = torch.empty((n, k), dtype=torch.float32, device=logits.device)
    if n == 0:
        return dlogits
    cw, gc = class_weights.contiguous(), g.contiguous()
    err = _kernel("bwd")(
        logits.data_ptr(), labels.data_ptr(), cw.data_ptr(), gc.data_ptr(), dlogits.data_ptr(), n, k,
        *_mode(ignore_index, gamma), logits.device.index, torch.cuda.current_stream(logits.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_ce backward kernel launch failed with CUDA error {err}")
    BWD_LAUNCHES += 1
    return dlogits


@_backward_op.register_fake
def _backward_fake(logits, labels, class_weights, g, ignore_index, gamma):
    return torch.empty_like(logits, dtype=torch.float32)


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def fused_ce_forward(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
    ignore_index: int | None = None, gamma: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (loss, weight), each (N,) f32, of (..., K) f32 logits and
    (...) int32 labels.

    Ports the forward of ``s2tpu/ops/fused_ce.py::fused_ce_per_pixel``
    (``:103-142``, TPU kernel ``_fwd_kernel`` ``:45-62``) as the custom op
    ``s2tpu_torch::fused_ce_forward``. A CUDA tensor goes through kernel
    #3, launched on the current stream without synchronising; a CPU tensor
    through the plain version. No autograd: :func:`fused_ce_per_pixel` is
    the differentiable op."""
    n, k = _check(logits, labels, class_weights)
    _check_device(logits, "fused_ce_forward")
    logits2, labels1 = logits.reshape(n, k).contiguous(), labels.reshape(n).contiguous()
    return torch.ops.s2tpu_torch.fused_ce_forward(logits2, labels1, class_weights, ignore_index, gamma)


def fused_ce_backward(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor, g: torch.Tensor,
    ignore_index: int | None = None, gamma: float | None = None,
) -> torch.Tensor:
    """``dlogits`` of shape ``logits.shape`` for the per-pixel cotangent
    ``g`` (N,) of the loss output.

    Ports ``s2tpu/ops/fused_ce.py::_vjp_bwd`` (``:150-180``, TPU kernel
    ``_bwd_kernel`` ``:65-85``) as the custom op
    ``s2tpu_torch::fused_ce_backward``. A CUDA tensor goes through kernel
    #4, launched on the current stream without synchronising; a CPU tensor
    through the plain version."""
    n, k = _check(logits, labels, class_weights)
    if g.shape != (n,) or g.dtype != torch.float32 or g.device != logits.device:
        raise ValueError(f"g must be ({n},) float32 on {logits.device}, got {tuple(g.shape)} {g.dtype} {g.device}")
    _check_device(logits, "fused_ce_backward")
    logits2, labels1 = logits.reshape(n, k).contiguous(), labels.reshape(n).contiguous()
    dlogits = torch.ops.s2tpu_torch.fused_ce_backward(logits2, labels1, class_weights, g, ignore_index, gamma)
    return dlogits.reshape(logits.shape)


class FusedCEPerPixel(torch.autograd.Function):
    """Differentiable per-pixel CE/focal: the port of the JAX custom VJP
    ``fused_ce_per_pixel`` (``s2tpu/ops/fused_ce.py:103-183``). Forward is
    kernel #3, backward kernel #4 with the full per-pixel cotangent of the
    loss output (``:159-162``); the weight output has no gradient."""

    @staticmethod
    def forward(ctx, logits, labels, class_weights, ignore_index, gamma):
        loss, weight = fused_ce_forward(logits, labels, class_weights, ignore_index, gamma)
        ctx.save_for_backward(logits, labels, class_weights)
        ctx.ignore_index, ctx.gamma = ignore_index, gamma
        ctx.mark_non_differentiable(weight)
        return loss, weight

    @staticmethod
    def backward(ctx, g_loss, _g_weight):
        logits, labels, class_weights = ctx.saved_tensors
        g = g_loss.to(torch.float32).contiguous()
        return fused_ce_backward(logits, labels, class_weights, g, ctx.ignore_index, ctx.gamma), None, None, None, None


def fused_ce_per_pixel(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
    ignore_index: int | None = None, gamma: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel fused CE/focal over flattened pixels -> (loss, weight), each (N,).

    CE mode (``gamma=None``): loss = w_y * ce, weight = w_y (masked); the
    weighted mean is loss.sum() / weight.sum(). Focal mode: loss =
    alpha_y * (1-pt)^gamma * ce (masked), weight = valid; the torch-parity
    mean is loss.sum() / N. Unlike the JAX function, there is no padding to a
    block multiple: N is the number of pixels.
    """
    return FusedCEPerPixel.apply(logits, labels, class_weights, ignore_index, gamma)


def fused_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor | None = None,
    ignore_index: int | None = None,
) -> torch.Tensor:
    """Weighted masked mean CE with torch semantics (``s2tpu/ops/fused_ce.py:186-194``)."""
    if class_weights is None:
        class_weights = torch.ones(logits.shape[-1], dtype=torch.float32, device=logits.device)
    loss, weight = fused_ce_per_pixel(logits, labels, class_weights, ignore_index, None)
    return loss.sum() / weight.sum().clamp_min(1e-12)


def fused_focal_loss(
    logits: torch.Tensor, labels: torch.Tensor, alpha: torch.Tensor, gamma: float,
    ignore_index: int | None = None,
) -> torch.Tensor:
    """Focal loss with the torch-parity mean over all pixels (``:197-205``)."""
    loss, _ = fused_ce_per_pixel(logits, labels, alpha, ignore_index, gamma)
    return loss.sum() / labels.numel()
