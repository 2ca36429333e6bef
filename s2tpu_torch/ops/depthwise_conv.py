"""Depthwise convolution: a hand-written CUDA kernel for stride 1, cuDNN for stride 2.

The port of ``s2tpu/ops/depthwise_conv.py``. The stride-1 SAME forward runs
in ``csrc/depthwise_conv.cu`` (which replaces the TPU kernel ``_fwd_kernel``);
stride 2 stays a grouped ``F.conv2d``, as the JAX package leaves it to XLA.

Layout follows the JAX package: ``x`` is (B, H, W, C) NHWC and ``w`` is
(k, k, C). B5 at 224^2 runs 35 stride-1 depthwise layers per forward, all
through the kernel. Only the forward pass is here; the input gradient (the
same kernel with the flipped filter) and the filter gradient come with the
training path.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Launches of the CUDA kernel; a run sets it to 0 and reads it to show that a
# path went through the kernel. Only the CUDA branch of the wrapper adds to it.
LAUNCHES = 0

SOURCES = ["depthwise_conv.cu"]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel keeps k*k weights of up to 64 channels in f32 shared memory and
# asks for no more than the default 48 KiB per block.
_MAX_K = 13
_MAX_CHANNEL_TILES = 65535  # gridDim.y


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


def depthwise_conv2d_s1_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch stride-1 SAME depthwise conv: the same k*k shifted
    multiply-adds as the kernel, accumulated in f32, cast to ``x.dtype``."""
    k = w.shape[0]
    _, h, wd, _ = x.shape
    lo, hi = (k - 1) // 2, k // 2
    xp = F.pad(x, (0, 0, lo, hi, lo, hi))
    wf = w.to(torch.float32)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy : dy + h, dx : dx + wd, :].to(torch.float32) * wf[dy, dx]
    return acc.to(x.dtype)


_kernel_fn = None


def _kernel():
    """The built kernel's C entry point (compiled with nvcc at first use)."""
    global _kernel_fn
    if _kernel_fn is None:
        from s2tpu_torch.ops._build import load_library

        fn = load_library("depthwise_conv", SOURCES).s2_depthwise_conv2d_s1_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def depthwise_conv2d_s1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME depthwise conv: (B, H, W, C) . (k, k, C) -> (B, H, W, C).

    A CUDA tensor goes through the hand-written kernel, launched on the
    current stream without synchronising; a CPU tensor through the plain
    version. Any other input raises.
    """
    global LAUNCHES
    k = _check(x, w)
    if x.device.type == "cpu":
        return depthwise_conv2d_s1_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv2d_s1 runs on cuda or cpu, not {x.device}")
    b, h, wd, c = x.shape
    if k > _MAX_K:
        raise ValueError(f"kernel size {k} > {_MAX_K} is not supported by the CUDA kernel")
    if -(-c // 64) > _MAX_CHANNEL_TILES or max(x.shape) > 2**31 - 1:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid limits")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, k,
        _DTYPE_CODES[x.dtype], x.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"depthwise_conv2d_s1 kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Depthwise conv dispatch, (B, H, W, C) . (k, k, C) -> NHWC.

    Stride 1 goes to :func:`depthwise_conv2d_s1`; stride 2 to a grouped
    ``F.conv2d`` (cuDNN on the card) with XLA's asymmetric SAME padding.
    """
    if stride == 1:
        return depthwise_conv2d_s1(x, w)
    k, c = w.shape[0], x.shape[-1]
    ph = same_padding(x.shape[1], k, stride)
    pw = same_padding(x.shape[2], k, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (*pw, *ph))
    y = F.conv2d(xc, w.permute(2, 0, 1).unsqueeze(1), stride=stride, groups=c)
    return y.permute(0, 2, 3, 1)
