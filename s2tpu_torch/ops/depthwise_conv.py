"""Depthwise convolution: hand-written CUDA kernels for stride 1, cuDNN for stride 2.

The port of ``s2tpu/ops/depthwise_conv.py``. Stride-1 SAME layers run
through :class:`DepthwiseConv2dS1`, whose passes are CUDA kernels:

- forward: ``csrc/depthwise_conv.cu`` (replaces the TPU kernel ``_fwd_kernel``);
- input gradient: the same kernel with the spatially flipped filter, exact
  for odd k at stride 1 (the JAX VJP, ``depthwise_conv.py:243-249``);
- filter gradient: ``csrc/depthwise_grad_weight.cu`` (replaces ``_dw_kernel``).

Stride 2 stays a grouped ``F.conv2d`` under autograd, as the JAX package
leaves it to XLA.

Layout follows the JAX package: ``x`` is (B, H, W, C) NHWC and ``w`` is
(k, k, C). B5 at 224^2 runs 35 stride-1 depthwise layers per forward, all
through the kernels.

All three passes are bound by bytes (2k^2 flops per element against 4-8
bytes). The kernels give neighbouring threads neighbouring channels of the
same pixels, so every warp load is one contiguous run of NHWC memory for any
C, and skip taps outside the image instead of padding in memory. The filter
gradient's blocks each own a channel tile and a slice of the B*H rows and
write their own partial sums: no block carries a sum to another, as the TPU
kernel's sequential grid does, and no atomics.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Launches of the CUDA kernels; a run sets them to 0 and reads them to show
# that a path went through the kernels. Only the CUDA branches of the
# wrappers add to them. LAUNCHES counts kernel #1 as a forward,
# DX_LAUNCHES the same kernel as an input gradient, DW_LAUNCHES kernel #2.
LAUNCHES = 0
DX_LAUNCHES = 0
DW_LAUNCHES = 0

SOURCES = ["depthwise_conv.cu"]
GRAD_WEIGHT_SOURCES = ["depthwise_grad_weight.cu"]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel keeps k*k weights of up to 64 channels in f32 shared memory and
# asks for no more than the default 48 KiB per block.
_MAX_K = 13
_MAX_CHANNEL_TILES = 65535  # gridDim.y
# The filter-gradient kernel unrolls k at compile time for these sizes.
_GRAD_WEIGHT_KS = (1, 3, 5, 7)
# Blocks the filter-gradient kernel aims for (4 per SM of an H100): the
# wrapper cuts the B*H image rows into as many slices as the channel tiles
# leave room for.
_GRAD_WEIGHT_TARGET_BLOCKS = 4 * 132


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding (low, high) for one spatial axis.

    ``total = max((ceil(n/s) - 1) * s + k - n, 0)`` split as
    ``(total // 2, total - total // 2)``: asymmetric for even sizes at
    stride 2 (k3 pads (0, 1), k5 pads (1, 2)), unlike torch's ``padding=``.
    """
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _check(x: torch.Tensor, w: torch.Tensor) -> int:
    if x.dim() != 4 or w.dim() != 3:
        raise ValueError(f"expected x (B, H, W, C) and w (k, k, C), got {tuple(x.shape)} and {tuple(w.shape)}")
    k = w.shape[0]
    if w.shape != (k, k, x.shape[3]) or k < 1:
        raise ValueError(f"w must be (k, k, C={x.shape[3]}), got {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share dtype float32 or bfloat16, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x must be NHWC-contiguous and w contiguous")
    return k


def _accumulation_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for the kernels' types (bf16, f32); f64 stays f64 (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def depthwise_conv2d_s1_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch stride-1 SAME depthwise conv: the same k*k shifted
    multiply-adds as the kernel, accumulated in f32, cast to ``x.dtype``."""
    k = w.shape[0]
    _, h, wd, _ = x.shape
    lo, hi = (k - 1) // 2, k // 2
    acc_dtype = _accumulation_dtype(x.dtype)
    xp = F.pad(x, (0, 0, lo, hi, lo, hi))
    wf = w.to(acc_dtype)
    acc = torch.zeros(x.shape, dtype=acc_dtype, device=x.device)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy : dy + h, dx : dx + wd, :].to(acc_dtype) * wf[dy, dx]
    return acc.to(x.dtype)


def depthwise_conv2d_s1_grad_weight_reference(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch filter gradient of the stride-1 SAME depthwise conv:
    ``dw[dy,dx,c] = sum_{b,y,x} g[b,y,x,c] * x_pad[b,y+dy,x+dx,c]`` as k*k
    shifted products summed over (B, H, W) in f32 -> (k, k, C) f32."""
    _, h, wd, c = x.shape
    lo, hi = (k - 1) // 2, k // 2
    acc_dtype = _accumulation_dtype(x.dtype)
    xp = F.pad(x, (0, 0, lo, hi, lo, hi)).to(acc_dtype)
    gf = g.to(acc_dtype)
    dw = torch.empty((k, k, c), dtype=acc_dtype, device=x.device)
    for dy in range(k):
        for dx in range(k):
            dw[dy, dx] = (gf * xp[:, dy : dy + h, dx : dx + wd, :]).sum(dim=(0, 1, 2))
    return dw


_kernel_fns: dict[str, object] = {}


def _kernel(name: str):
    """A built kernel's C entry point (compiled with nvcc at first use)."""
    fn = _kernel_fns.get(name)
    if fn is None:
        from s2tpu_torch.ops._build import load_library

        if name == "fwd":
            fn = load_library("depthwise_conv", SOURCES).s2_depthwise_conv2d_s1_fwd
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        else:
            fn = load_library("depthwise_grad_weight", GRAD_WEIGHT_SOURCES).s2_depthwise_conv2d_s1_grad_weight
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fns[name] = fn
    return fn


def _launch_forward(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel #1 on CUDA tensors that passed ``_check``."""
    b, h, wd, c = x.shape
    if k > _MAX_K:
        raise ValueError(f"kernel size {k} > {_MAX_K} is not supported by the CUDA kernel")
    if -(-c // 64) > _MAX_CHANNEL_TILES or max(x.shape) > 2**31 - 1:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid limits")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel("fwd")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, k,
        _DTYPE_CODES[x.dtype], x.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"depthwise_conv2d_s1 kernel launch failed with CUDA error {err}")
    return out


def depthwise_conv2d_s1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME depthwise conv: (B, H, W, C) . (k, k, C) -> (B, H, W, C).

    Ports ``s2tpu/ops/depthwise_conv.py::_forward`` (``:173-200``). A CUDA
    tensor goes through the hand-written kernel, launched on the current
    stream without synchronising; a CPU tensor through the plain version.
    Any other input raises. No autograd: :class:`DepthwiseConv2dS1` is the
    differentiable op.
    """
    global LAUNCHES
    k = _check(x, w)
    if x.device.type == "cpu":
        return depthwise_conv2d_s1_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv2d_s1 runs on cuda or cpu, not {x.device}")
    out = _launch_forward(x, w, k)
    LAUNCHES += 1
    return out


def depthwise_conv2d_s1_input_grad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the stride-1 SAME depthwise conv: kernel #1 on the
    cotangent ``g`` with the spatially flipped filter, exact for odd k
    (``s2tpu/ops/depthwise_conv.py:243-249``). CUDA launches count in
    ``DX_LAUNCHES``; a CPU tensor takes the plain version."""
    global DX_LAUNCHES
    k = _check(g, w)
    if k % 2 == 0:
        raise ValueError(f"the flipped-filter input gradient is exact for odd k only, got k={k}")
    w_flip = w.flip(0, 1).contiguous()
    if g.device.type == "cpu":
        return depthwise_conv2d_s1_reference(g, w_flip)
    if g.device.type != "cuda":
        raise ValueError(f"depthwise_conv2d_s1_input_grad runs on cuda or cpu, not {g.device}")
    out = _launch_forward(g, w_flip, k)
    DX_LAUNCHES += 1
    return out


def _grad_weight_slices(b: int, h: int, c: int) -> tuple[int, int]:
    """(n_slices, rows_per_slice) over the B*H image rows for kernel #2.

    The kernel's channel tile is 32 channel groups of 2 channels (1 where C
    is odd), so C/64 tiles leave room for ``_GRAD_WEIGHT_TARGET_BLOCKS`` /
    tiles row slices: small-C maps get their blocks from rows, large-C maps
    from channels."""
    vec = 2 if c % 2 == 0 else 1
    tile_c = min(c // vec, 32) * vec
    tiles = -(-c // tile_c)
    rows = b * h
    n_slices = min(rows, max(1, -(-_GRAD_WEIGHT_TARGET_BLOCKS // tiles)))
    rows_per_slice = -(-rows // n_slices)
    return -(-rows // rows_per_slice), rows_per_slice


def depthwise_conv2d_s1_grad_weight(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Filter gradient of the stride-1 SAME depthwise conv -> (k, k, C) f32.

    Ports ``s2tpu/ops/depthwise_conv.py::_grad_weight`` (``:203-230``, TPU
    kernel ``_dw_kernel`` ``:101-142``). A CUDA tensor goes through kernel
    #2 (``csrc/depthwise_grad_weight.cu``), which writes per-row-slice f32
    partial sums that are summed here, as the JAX package sums its
    per-image partials outside the kernel; a CPU tensor takes the plain
    version. ``x`` and ``g`` are (B, H, W, C) NHWC-contiguous of one dtype.
    """
    global DW_LAUNCHES
    if x.dim() != 4 or g.shape != x.shape or k < 1:
        raise ValueError(f"expected x and g (B, H, W, C) of one shape and k >= 1, got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}, k={k}")
    if x.dtype not in _DTYPE_CODES or g.dtype != x.dtype:
        raise TypeError(f"x and g must share dtype float32 or bfloat16, got {x.dtype} and {g.dtype}")
    if g.device != x.device:
        raise ValueError(f"x on {x.device} but g on {g.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be NHWC-contiguous")
    if x.device.type == "cpu":
        return depthwise_conv2d_s1_grad_weight_reference(x, g, k)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv2d_s1_grad_weight runs on cuda or cpu, not {x.device}")
    if k not in _GRAD_WEIGHT_KS:
        raise ValueError(f"kernel size {k} is not one of the filter-gradient kernel's {_GRAD_WEIGHT_KS}")
    b, h, wd, c = x.shape
    if max(x.shape) > 2**31 - 1 or b * h > 2**31 - 1:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid limits")
    if x.numel() == 0:
        return torch.zeros((k, k, c), dtype=torch.float32, device=x.device)
    n_slices, rows_per_slice = _grad_weight_slices(b, h, c)
    partial = torch.empty((n_slices, k * k, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel("dw")(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), b, h, wd, c, k, n_slices, rows_per_slice,
        _DTYPE_CODES[x.dtype], x.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"depthwise_conv2d_s1_grad_weight kernel launch failed with CUDA error {err}")
    DW_LAUNCHES += 1
    return partial.sum(0).reshape(k, k, c)


def _backward(ctx, g: torch.Tensor, input_grad, grad_weight):
    x, w = ctx.saved_tensors
    # The cotangent arrives through the model's NHWC <-> channels-last
    # permutes; the kernels read plain NHWC memory.
    g = g.contiguous()
    dx = input_grad(g, w).to(x.dtype) if ctx.needs_input_grad[0] else None
    dw = grad_weight(x, g, w.shape[0]).to(w.dtype) if ctx.needs_input_grad[1] else None
    return dx, dw


class DepthwiseConv2dS1(torch.autograd.Function):
    """Differentiable stride-1 SAME depthwise conv, the port of the JAX
    ``depthwise_conv2d_s1`` custom VJP (``s2tpu/ops/depthwise_conv.py:233-252``):
    forward kernel #1, input gradient kernel #1 with the flipped filter,
    filter gradient kernel #2; both gradients cast to the input's dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return depthwise_conv2d_s1(x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _backward(ctx, g, depthwise_conv2d_s1_input_grad, depthwise_conv2d_s1_grad_weight)


class DepthwiseConv2dS1Reference(torch.autograd.Function):
    """The same three passes in plain PyTorch, on any device and float dtype
    (f64 for ``torch.autograd.gradcheck``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return depthwise_conv2d_s1_reference(x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _backward(
            ctx, g, lambda g, w: depthwise_conv2d_s1_reference(g, w.flip(0, 1)),
            depthwise_conv2d_s1_grad_weight_reference,
        )


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Depthwise conv dispatch, (B, H, W, C) . (k, k, C) -> NHWC, differentiable.

    Stride 1 goes to :class:`DepthwiseConv2dS1` (the CUDA kernels on the
    card); stride 2 to a grouped ``F.conv2d`` (cuDNN on the card) with XLA's
    asymmetric SAME padding.
    """
    if stride == 1:
        return DepthwiseConv2dS1.apply(x, w)
    k, c = w.shape[0], x.shape[-1]
    ph = same_padding(x.shape[1], k, stride)
    pw = same_padding(x.shape[2], k, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (*pw, *ph))
    y = F.conv2d(xc, w.permute(2, 0, 1).unsqueeze(1), stride=stride, groups=c)
    return y.permute(0, 2, 3, 1)
