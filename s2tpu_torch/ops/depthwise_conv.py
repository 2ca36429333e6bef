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
bytes). Both kernels stage their tiles in shared memory once (16-byte
cp.async copies where C and the addresses allow), with the SAME padding as
zeros there, and give neighbouring threads neighbouring channels of the same
pixels. The filter gradient's blocks each own a channel tile, a column tile
and a slice of the B*H rows and write their own partial sums, which the
kernel adds in two ordered levels: no block carries a sum to another, as the
TPU kernel's sequential grid does, and no atomics on values. The
wrappers' tile plans (``_forward_plan``, ``_grad_weight_plan``,
``_piece_bytes``) are plain Python, held by the CPU tests; the tile shape
they share with the kernels is set once, in ``csrc/depthwise_tiles.h``, and
both kernels' grids are rounds of the blocks the card holds at once.

Each kernel entry is a ``torch.library`` custom op (``s2tpu_torch::
depthwise_conv2d_s1``, ``..._input_grad``, ``..._grad_weight``) whose CUDA
implementation launches the hand-written kernel and whose CPU
implementation is the plain version; a fake version gives the output shape,
so ``torch.export`` traces a model through them, and a FLOP formula lets
``FlopCounterMode`` count them.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

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
# Kernel #1 unrolls k <= 7 with the weights in registers and reads them tap
# by tap from global memory above that; its halo tile fits shared memory up
# to k = 13.
_MAX_K = 13
_MAX_CHANNEL_TILES = 65535  # gridDim.y
_CHANNEL_GROUPS = 32  # channel words of a tile: one warp's lanes
_FWD_SHARED_BYTES = 112 * 1024  # kernel #1's block: 2 fit an SM
# The filter-gradient kernel unrolls k at compile time for these sizes.
_GRAD_WEIGHT_KS = (1, 3, 5, 7)
# Kernel #2's plan (_grad_weight_plan): pixels a thread walks between
# barriers, the widest column tile, the longest sum a thread carries, and a
# block's shared memory.
_DW_ROW_PIXELS = 28
_DW_MAX_WT = 32
_DW_THREAD_CHAIN = 800
_DW_SHARED_BYTES = 96 * 1024
# Both grids are rounds of the blocks the card holds at once (the occupancy
# API, asked once per plan: _resident_blocks). #1's blocks walk their tiles,
# the next one's copy in flight, over 2 rounds (1, 2 and 4 measured on the
# H100 at B5's shapes: 2 fastest); #2's blocks each own a slice of rows and
# write one partial, in one round, as few partials as fill the card.
_FWD_ROUNDS = 2
_DW_ROUNDS = 1


def _tile_constants() -> dict[str, int]:
    """The kernels' fixed tile shape, ``DW_<NAME> <value>``, read from
    ``csrc/depthwise_tiles.h``, which both CUDA sources include: the one
    place it is set."""
    text = (Path(__file__).resolve().parent / "csrc" / "depthwise_tiles.h").read_text()
    return {m[1]: int(m[2]) for m in re.finditer(r"^#define (DW_\w+) (\d+)", text, re.MULTILINE)}


_TILES = _tile_constants()
_MAX_THREADS = _TILES["DW_MAX_THREADS"]  # both kernels' __launch_bounds__
_FWD_PATCH = (_TILES["DW_FWD_RY"], _TILES["DW_FWD_RX"])  # kernel #1's outputs per thread
_DW_STAGES = _TILES["DW_GRAD_STAGES"]  # row groups of kernel #2 in shared memory at once


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
# name -> (library, sources, C symbol, argument types)
_RESIDENT_ARGS = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
_ENTRY_POINTS = {
    "fwd": ("depthwise_conv", SOURCES, "s2_depthwise_conv2d_s1_fwd",
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + [ctypes.c_void_p]),
    "fwd_resident": ("depthwise_conv", SOURCES, "s2_depthwise_conv2d_s1_fwd_resident", _RESIDENT_ARGS),
    "dw": ("depthwise_grad_weight", GRAD_WEIGHT_SOURCES, "s2_depthwise_conv2d_s1_grad_weight",
           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p]),
    "dw_resident": ("depthwise_grad_weight", GRAD_WEIGHT_SOURCES, "s2_depthwise_conv2d_s1_grad_weight_resident",
                    _RESIDENT_ARGS),
}


def _kernel(name: str):
    """A built library's C entry point (compiled with nvcc at first use)."""
    fn = _kernel_fns.get(name)
    if fn is None:
        from s2tpu_torch.ops._build import load_library

        library, sources, symbol, argtypes = _ENTRY_POINTS[name]
        fn = getattr(load_library(library, sources), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _kernel_fns[name] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _resident_blocks(kernel: str, device: int, c: int, k: int, threads: int, smem: int, dtype: int) -> int:
    """Blocks of kernel #1 (``"fwd"``) or #2 (``"dw"``) at this plan that the
    card holds at once, all SMs together (the occupancy API: registers,
    shared memory and threads decide); asked once per plan."""
    blocks = ctypes.c_int(0)
    err = _kernel(f"{kernel}_resident")(c, k, threads, smem, dtype, device, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"depthwise {kernel} occupancy query failed with CUDA error {err}")
    return max(blocks.value, 1)


def _channel_groups(c: int) -> tuple[int, int]:
    """(VEC, TG): channels a thread owns (a pair where C is even, as the
    kernels choose) and channel groups per tile (one warp's 32 lanes, fewer
    where C is narrower)."""
    vec = 2 if c % 2 == 0 else 1
    return vec, min(c // vec, _CHANNEL_GROUPS)


def _piece_bytes(c: int, *tensors: torch.Tensor) -> int:
    """Bytes per staged copy: the widest of 16, 8, 4 and 2 (not below one
    element) that divides a pixel's C channels and every tensor's address.
    16 for the B5 shapes; 4 (bf16) for C = 130; 2 for bf16 with odd C or a
    view that starts off a 4-byte boundary."""
    elem = tensors[0].element_size()
    for n in (16, 8, 4, 2):
        if n >= elem and (c * elem) % n == 0 and all(t.data_ptr() % n == 0 for t in tensors):
            return n
    raise ValueError(f"no copy width for C={c} at addresses {[t.data_ptr() for t in tensors]}")


@functools.lru_cache(maxsize=None)
def _forward_plan(h: int, w: int, c: int, k: int, elem: int) -> tuple[int, int, int]:
    """(TG, PX, PY) for kernel #1: channel groups per tile, and patches of
    ``_FWD_PATCH`` (2 x 4) outputs across and down a block's tile.

    A block has at most ``_MAX_THREADS`` threads, TG per patch. The patches
    go first along W, as few tiles across as cover it and as even as they
    can be (W = 7: 2 patches, 8 columns; W = 28: 7 patches), the rest down H
    the same way, so the tiles cover the map with little overhang. Fewer
    patches where the shared memory would pass ``_FWD_SHARED_BYTES`` (large
    k in f32)."""
    vec, tg = _channel_groups(c)
    ry, rx = _FWD_PATCH
    nx, ny = -(-w // rx), -(-h // ry)
    patches = max(1, _MAX_THREADS // tg)
    while True:
        px = -(-nx // -(-nx // patches))
        per_column = max(1, patches // px)
        py = -(-ny // -(-ny // per_column))
        py = max(py, -(-vec // px))  # at least as many threads as a pixel has copy pieces (<= TG * VEC)
        if patches == 1 or _forward_shared_bytes(tg * vec, px, py, k, elem) <= _FWD_SHARED_BYTES:
            return tg, px, py
        patches //= 2


def _forward_shared_bytes(tc: int, px: int, py: int, k: int, elem: int) -> int:
    """Shared memory of one kernel #1 block: two halo tiles (the next one's
    copy in flight) and the output tile. The launch passes it to the kernel,
    which refuses a size that is not its own layout's."""
    th, tw = py * _FWD_PATCH[0], px * _FWD_PATCH[1]
    return (2 * (th + k - 1) * (tw + k - 1) + th * tw) * tc * elem


@functools.lru_cache(maxsize=None)
def _grad_weight_tile(w: int, c: int, k: int, elem: int) -> tuple[int, int, int, int]:
    """(TG, S, R2, WT): kernel #2's block, which the shape of its grid
    (:func:`_grad_weight_plan`) does not change.

    Threads: TG channel groups x k tap rows x S row splits (at most
    ``_MAX_THREADS``, and at least TG * VEC, a pixel's copy pieces); each
    split walks R2 rows of a group of RC = S R2 rows, R2 chosen so that a
    thread walks ``_DW_ROW_PIXELS`` pixels or more between barriers.
    Columns: tiles of WT <= ``_DW_MAX_WT``. A block's shared memory (the x
    ring, the g stages) is kept under ``_DW_SHARED_BYTES``."""
    vec, tg = _channel_groups(c)
    s = max(1, _MAX_THREADS // (tg * k))
    n_wt = -(-w // _DW_MAX_WT)
    wt = -(-w // n_wt)
    r2 = -(-_DW_ROW_PIXELS // wt)
    while _grad_weight_shared_bytes(tg * vec, s, r2, wt, k, elem) > _DW_SHARED_BYTES and (r2 > 1 or s > 1):
        if r2 > 1:
            r2 -= 1
        else:
            s -= 1
    return tg, max(s, -(-vec // k)), r2, wt


@functools.lru_cache(maxsize=None)
def _grad_weight_plan(
    b: int, h: int, w: int, c: int, k: int, elem: int, target_blocks: int
) -> tuple[int, int, int, int, int, int]:
    """(TG, S, R2, WT, n_slices, rows_per_slice) for kernel #2: the block of
    :func:`_grad_weight_tile`, and the B*H rows cut into slices of a
    multiple of RC rows, enough that channel tiles x column tiles x slices
    give ``target_blocks`` blocks (small-C maps get their blocks from rows,
    large-C maps from channels), and short enough that a thread's chain of
    additions stays under ``_DW_THREAD_CHAIN`` (see
    :func:`_grad_weight_chain`)."""
    tg, s, r2, wt = _grad_weight_tile(w, c, k, elem)
    vec, _ = _channel_groups(c)
    rc = s * r2
    tiles, n_wt = -(-c // (tg * vec)), -(-w // wt)
    rows = b * h
    n_slices = min(-(-rows // rc), max(1, -(-target_blocks // (tiles * n_wt))))
    rows_per_slice = rc * -(-(-(-rows // n_slices)) // rc)
    rows_per_slice = min(rows_per_slice, rc * max(1, _DW_THREAD_CHAIN // (r2 * wt)))
    return tg, s, r2, wt, -(-rows // rows_per_slice), rows_per_slice


def _grad_weight_shared_bytes(tc: int, s: int, r2: int, wt: int, k: int, elem: int) -> int:
    """Shared memory of one kernel #2 block: the x ring (STAGES RC + k - 1
    rows of WT + k - 1 pixels) and STAGES g stages (RC rows of WT), or the
    combine of the S splits' sums where that is larger. The launch passes it
    to the kernel, which refuses a size that is not its own layout's."""
    rc = s * r2
    stage = ((_DW_STAGES * rc + k - 1) * (wt + k - 1) + _DW_STAGES * rc * wt) * tc * elem
    return max(stage, s * k * k * tc * 4)


def _partial_groups(n_parts: int) -> tuple[int, int]:
    """(G, n_g): kernel #2 adds a channel tile's n_parts partials in groups of
    G ~ sqrt(n_parts), then the n_g group sums, each level in order."""
    group = max(1, round(n_parts**0.5))
    return group, -(-n_parts // group)


def _grad_weight_chain(b: int, h: int, w: int, c: int, k: int, elem: int, target_blocks: int) -> int:
    """Longest chain of f32 additions into one filter-gradient value under
    kernel #2's plan: a thread's sum over its rows of every group times the
    column tile's width, the combine of the S splits, then a group of
    partials and the group sums, in order."""
    tg, s, r2, wt, n_slices, rows_per_slice = _grad_weight_plan(b, h, w, c, k, elem, target_blocks)
    group, n_g = _partial_groups(n_slices * -(-w // wt))
    return r2 * -(-rows_per_slice // (s * r2)) * wt + (s - 1) + group + (n_g if n_g > 1 else 0)


_tickets: dict[tuple[int | None, int], torch.Tensor] = {}


def _ticket_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Kernel #2's ticket counters (n_g + 1 per channel tile) for launches on
    ``stream``: zeros, allocated once per (device, stream) and grown when a
    launch needs more; each launch leaves the counters it used at zero."""
    key = (device.index, stream)
    counters = _tickets.get(key)
    if counters is None or counters.numel() < n:
        counters = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _tickets[key] = counters
    return counters


def _launch_forward(x: torch.Tensor, w: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """Kernel #1 on CUDA tensors that passed ``_check``; ``flip`` reads the
    filter as ``w.flip(0, 1)`` by index."""
    b, h, wd, c = x.shape
    if k > _MAX_K:
        raise ValueError(f"kernel size {k} > {_MAX_K} is not supported by the CUDA kernel")
    vec, _ = _channel_groups(c)
    elem, dtype = x.element_size(), _DTYPE_CODES[x.dtype]
    tg, px, py = _forward_plan(h, wd, c, k, elem)
    tiles = b * -(-h // (py * _FWD_PATCH[0])) * -(-wd // (px * _FWD_PATCH[1]))
    c_tiles = -(-c // (tg * vec))
    if c_tiles > _MAX_CHANNEL_TILES or tiles > 2**31 - 1:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid limits")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    threads, smem = tg * px * py, _forward_shared_bytes(tg * vec, px, py, k, elem)
    resident = _resident_blocks("fwd", x.device.index, c, k, threads, smem, dtype)
    workers = min(-(-_FWD_ROUNDS * resident // c_tiles), tiles)  # blocks per channel tile
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel("fwd")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, k, tg, px, py, workers, _piece_bytes(c, x, out),
        smem, int(flip), dtype, x.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"depthwise_conv2d_s1 kernel launch failed with CUDA error {err}")
    return out


@torch.library.custom_op("s2tpu_torch::depthwise_conv2d_s1", mutates_args=(), device_types="cpu")
def _forward_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return depthwise_conv2d_s1_reference(x, w)


@_forward_op.register_kernel("cuda")
def _forward_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    out = _launch_forward(x, w, w.shape[0], flip=False)
    LAUNCHES += 1
    return out


@torch.library.custom_op("s2tpu_torch::depthwise_conv2d_s1_input_grad", mutates_args=(), device_types="cpu")
def _input_grad_op(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return depthwise_conv2d_s1_reference(g, w.flip(0, 1))


@_input_grad_op.register_kernel("cuda")
def _input_grad_cuda(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global DX_LAUNCHES
    out = _launch_forward(g, w, w.shape[0], flip=True)
    DX_LAUNCHES += 1
    return out


@_forward_op.register_fake
@_input_grad_op.register_fake
def _forward_fake(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x)


@torch.library.custom_op("s2tpu_torch::depthwise_conv2d_s1_grad_weight", mutates_args=(), device_types="cpu")
def _grad_weight_op(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    return depthwise_conv2d_s1_grad_weight_reference(x, g, k)


@_grad_weight_op.register_kernel("cuda")
def _grad_weight_cuda(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    global DW_LAUNCHES
    out = _launch_grad_weight(x, g, k)
    DW_LAUNCHES += 1
    return out


@_grad_weight_op.register_fake
def _grad_weight_fake(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    return x.new_empty((k, k, x.shape[-1]), dtype=_accumulation_dtype(x.dtype))


def _depthwise_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """2 k^2 operations an element: the forward, the input gradient and the
    filter gradient alike (the filter gradient's ``k`` is the last argument)."""
    k = w_shape[0] if isinstance(w_shape, (tuple, list, torch.Size)) else w_shape
    return 2 * k * k * math.prod(x_shape)


register_flop_formula(torch.ops.s2tpu_torch.depthwise_conv2d_s1)(_depthwise_flops)
register_flop_formula(torch.ops.s2tpu_torch.depthwise_conv2d_s1_input_grad)(_depthwise_flops)
register_flop_formula(torch.ops.s2tpu_torch.depthwise_conv2d_s1_grad_weight)(
    lambda x_shape, g_shape, k, out_shape=None, **kw: 2 * k * k * math.prod(x_shape)
)


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def depthwise_conv2d_s1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME depthwise conv: (B, H, W, C) . (k, k, C) -> (B, H, W, C).

    Ports ``s2tpu/ops/depthwise_conv.py::_forward`` (``:173-200``) as the
    custom op ``s2tpu_torch::depthwise_conv2d_s1``. A CUDA tensor goes
    through the hand-written kernel, launched on the current stream without
    synchronising; a CPU tensor through the plain version. Any other input
    raises. No autograd: :class:`DepthwiseConv2dS1` is the differentiable op.
    """
    _check(x, w)
    _check_device(x, "depthwise_conv2d_s1")
    return torch.ops.s2tpu_torch.depthwise_conv2d_s1(x, w)


def depthwise_conv2d_s1_input_grad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the stride-1 SAME depthwise conv: the forward of the
    cotangent ``g`` with the spatially flipped filter, exact for odd k
    (``s2tpu/ops/depthwise_conv.py:243-249``), as the custom op
    ``s2tpu_torch::depthwise_conv2d_s1_input_grad``. On CUDA, kernel #1
    reads the filter flipped by index (no flipped copy; launches count in
    ``DX_LAUNCHES``); a CPU tensor takes the plain version of the flip."""
    k = _check(g, w)
    if k % 2 == 0:
        raise ValueError(f"the flipped-filter input gradient is exact for odd k only, got k={k}")
    _check_device(g, "depthwise_conv2d_s1_input_grad")
    return torch.ops.s2tpu_torch.depthwise_conv2d_s1_input_grad(g, w)


def depthwise_conv2d_s1_grad_weight(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Filter gradient of the stride-1 SAME depthwise conv -> (k, k, C) f32.

    Ports ``s2tpu/ops/depthwise_conv.py::_grad_weight`` (``:203-230``, TPU
    kernel ``_dw_kernel`` ``:101-142``) as the custom op
    ``s2tpu_torch::depthwise_conv2d_s1_grad_weight``. A CUDA tensor goes
    through kernel #2 (``csrc/depthwise_grad_weight.cu``), one launch: its
    blocks write f32 partial sums, which the kernel adds in two ordered
    levels (the JAX package sums its per-image partials outside the
    kernel); a CPU tensor takes the plain version. ``x`` and ``g`` are
    (B, H, W, C) NHWC-contiguous of one dtype.
    """
    if x.dim() != 4 or g.shape != x.shape or k < 1:
        raise ValueError(f"expected x and g (B, H, W, C) of one shape and k >= 1, got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}, k={k}")
    if x.dtype not in _DTYPE_CODES or g.dtype != x.dtype:
        raise TypeError(f"x and g must share dtype float32 or bfloat16, got {x.dtype} and {g.dtype}")
    if g.device != x.device:
        raise ValueError(f"x on {x.device} but g on {g.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be NHWC-contiguous")
    _check_device(x, "depthwise_conv2d_s1_grad_weight")
    return torch.ops.s2tpu_torch.depthwise_conv2d_s1_grad_weight(x, g, k)


def _launch_grad_weight(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel #2 on CUDA tensors that passed the wrapper's checks."""
    if k not in _GRAD_WEIGHT_KS:
        raise ValueError(f"kernel size {k} is not one of the filter-gradient kernel's {_GRAD_WEIGHT_KS}")
    b, h, wd, c = x.shape
    if x.numel() == 0:
        return torch.zeros((k, k, c), dtype=torch.float32, device=x.device)
    vec, _ = _channel_groups(c)
    elem, dtype = x.element_size(), _DTYPE_CODES[x.dtype]
    tg, s, r2, wt = _grad_weight_tile(wd, c, k, elem)
    smem = _grad_weight_shared_bytes(tg * vec, s, r2, wt, k, elem)
    resident = _resident_blocks("dw", x.device.index, c, k, tg * k * s, smem, dtype)
    _, _, _, _, n_slices, rows_per_slice = _grad_weight_plan(b, h, wd, c, k, elem, _DW_ROUNDS * resident)
    n_parts, tiles = n_slices * -(-wd // wt), -(-c // (tg * vec))
    if b * h > 2**31 - 1 or n_parts > 2**31 - 1 or tiles > _MAX_CHANNEL_TILES:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid limits")
    out = torch.empty((k, k, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    group, n_g = _partial_groups(n_parts)
    partial = torch.empty((n_parts + n_g, k * k, c), dtype=torch.float32, device=x.device)
    tickets = _ticket_counters(x.device, stream, tiles * (n_g + 1))
    err = _kernel("dw")(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(), tickets.data_ptr(), b, h, wd, c, k, tg, s,
        r2, wt, n_slices, rows_per_slice, group, _piece_bytes(c, x, g), smem, dtype, x.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"depthwise_conv2d_s1_grad_weight kernel launch failed with CUDA error {err}")
    return out


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
