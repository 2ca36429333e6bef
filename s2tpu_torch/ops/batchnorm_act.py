"""Train-mode BatchNorm with its activation: hand-written CUDA kernels for all five passes.

The model's BatchNorms (``models/efficientnet_unet.py``, the fc-prithvi
head) normalize with flax's train-mode semantics: f32 batch statistics as
E[x^2] - E[x]^2 clipped at 0, the affine in f32 rounded to the activation
dtype, then the activation (none, SiLU or ReLU) on that rounded output, and
the running statistics updated with the biased variance. On the card the
plain PyTorch form of that is some twenty f32 passes a layer and saves f32
copies of the activation for the backward. :func:`batchnorm_act` runs the
layer, activation included, as :class:`BatchNormAct`, whose passes are the
kernels of ``csrc/batchnorm_act.cu``:

- forward: ``stats`` (per-channel f32 sums of x and x^2), ``finalize`` (mean,
  invstd, the clamp's mask, and the running statistics in the same launch),
  ``apply`` (the affine, its rounding and the activation);
- backward: ``backward_sums`` (per-channel sums of dz and dz * xhat, which
  are also the gradients of beta and gamma) and ``backward_dx``.

On a data axis of several ranks the forward's and the backward's (2, C)
sums pass through ``DataAxis.sum`` before the kernel that reads them, and
the count is the global batch's, as the plain form sums its statistics; the
gradients of gamma and beta stay this rank's own sums. The backward saves x
itself and the (3, C) statistics: no f32 copy.

The kernels replace no TPU kernel (the JAX package leaves BatchNorm to XLA)
and are bound by bytes: 6 B an element forward and 10 B backward in bf16,
each pass one read of its inputs, coalesced, in vectors of 4 channels where
C and the addresses allow. Their reductions add in a fixed order (per-block
partials, then the last block of a channel tile adds them in block order),
so a layer gives the same bits on every run and in a CUDA graph. The launch
plans (:func:`vector_width`, :func:`plan`) are plain Python, held by the CPU
tests.

Each pass is a ``torch.library`` custom op (``s2tpu_torch::batchnorm_act_*``)
whose CUDA implementation launches the kernel and whose CPU implementation
is the plain PyTorch version of the same pass, and a fake version gives the
output shapes. Every train-mode call on the card takes the kernels; the
model's CPU path keeps the plain autograd form of the layer
(:func:`batchnorm_act_plain`), and the tests run :class:`BatchNormAct` on the
CPU through the passes' plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from s2tpu_torch import profiling
from s2tpu_torch.parallel.mesh import SINGLE, DataAxis

# Fused forwards on the card (one per layer call: stats, finalize and apply;
# the backward's two kernels run with it); a run sets it to 0 and reads it to
# show that a path went through the kernels. A graph replay adds nothing.
LAUNCHES = 0

SOURCES = ["batchnorm_act.cu"]
ACTIVATIONS = {"none": 0, "silu": 1, "relu": 2}
_ACT_NAMES = {code: name for name, code in ACTIVATIONS.items()}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The launch plan (:func:`plan`), chosen by timing every B5 BatchNorm shape of
# a step at batch 32 in bf16 on the H100 for vectors of 4 or 8 channels, tiles
# of 8, 16 or 32 vectors, blocks of 256 or 512 threads and 2, 4 or 8 blocks an
# SM: this one gave the least time a step summed over the four row passes.
_MAX_VEC = 4  # channels a thread loads at once (the kernels' widest)
_MAX_TILE = 16  # channel vectors of a block's tile
_THREADS = 256  # a block's threads at most (the kernels' __launch_bounds__)
_BLOCKS_PER_SM = 4  # blocks an SM holds at once (__launch_bounds__' minimum)


def activation(y: torch.Tensor, act: str) -> torch.Tensor:
    """The activation the layer applies to its normalized output: torch's
    own SiLU or ReLU (the ops ``nn.SiLU`` and ``nn.ReLU`` call), or none."""
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return F.relu(y)
    if act == "none":
        return y
    raise ValueError(f"activation {act!r} is not one of {sorted(ACTIVATIONS)}")


def batchnorm_act_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
    running_var: torch.Tensor, num_batches_tracked: torch.Tensor, eps: float, decay: float, act: str,
    data_axis: DataAxis = SINGLE, update: bool = True,
) -> torch.Tensor:
    """The layer in plain PyTorch under autograd: f32 statistics (summed over
    ``data_axis``, differentiably), the running statistics' update (with
    ``update``), the f32 affine cast back to ``x.dtype``, the activation."""
    xf = x.to(torch.float32)
    if data_axis.size == 1:
        mean, ex2 = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
    else:
        sums = data_axis.sum(torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))]))
        mean, ex2 = sums / (xf.numel() // xf.shape[1] * data_axis.size)
    var = (ex2 - mean * mean).clamp_min(0.0)
    if update:
        with torch.no_grad():
            running_mean.copy_(decay * running_mean + (1.0 - decay) * mean)
            running_var.copy_(decay * running_var + (1.0 - decay) * var)
            num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + eps) * weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    return activation(y.to(x.dtype), act)


# ---------------------------------------------------------------------------
# The passes' plain versions, on (N, C, H, W) tensors of any memory format.
# ---------------------------------------------------------------------------
def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t[:, None, None]


def stats_reference(x: torch.Tensor) -> torch.Tensor:
    """(2, C) f32: each channel's sum of x and of x^2."""
    xf = x.to(torch.float32)
    return torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])


def finalize_reference(
    sums: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor, num_batches_tracked: torch.Tensor,
    count: float, eps: float, decay: float, update: bool,
) -> torch.Tensor:
    """(3, C) f32 ``saved``: mean, invstd and the clamp's gradient mask (1
    where E[x^2] - E[x]^2 >= 0), from the sums over ``count`` rows; with
    ``update``, the running statistics and ``num_batches_tracked`` in place."""
    mean, ex2 = sums[0] / count, sums[1] / count
    raw = ex2 - mean * mean
    var = raw.clamp_min(0.0)
    if update:
        running_mean.copy_(decay * running_mean + (1.0 - decay) * mean)
        running_var.copy_(decay * running_var + (1.0 - decay) * var)
        num_batches_tracked.add_(1)
    return torch.stack([mean, torch.rsqrt(var + eps), (raw >= 0).to(torch.float32)])


def _normalized(x: torch.Tensor, saved: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """z: the f32 affine rounded to ``x.dtype``."""
    mul = saved[1] * weight
    return ((x.to(torch.float32) - _per_channel(saved[0])) * _per_channel(mul) + _per_channel(bias)).to(x.dtype)


def apply_reference(x: torch.Tensor, saved: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    act: int) -> torch.Tensor:
    """act(z), in ``x.dtype``."""
    return activation(_normalized(x, saved, weight, bias), _ACT_NAMES[act])


def _grad_parts(x, dy, saved, weight, bias, act: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dz, xhat) in f32: dz = dy * act'(z) rounded to ``x.dtype`` by
    torch's own activation backward, xhat = (x - mean) * invstd."""
    z = _normalized(x, saved, weight, bias)
    if act == ACTIVATIONS["silu"]:
        dz = torch.ops.aten.silu_backward(dy, z)
    elif act == ACTIVATIONS["relu"]:
        dz = torch.ops.aten.threshold_backward(dy, F.relu(z), 0)
    else:
        dz = dy
    xhat = (x.to(torch.float32) - _per_channel(saved[0])) * _per_channel(saved[1])
    return dz.to(torch.float32), xhat


def backward_sums_reference(x, dy, saved, weight, bias, act: int) -> torch.Tensor:
    """(2, C) f32: each channel's sum of dz (the gradient of beta) and of
    dz * xhat (the gradient of gamma)."""
    dz, xhat = _grad_parts(x, dy, saved, weight, bias, act)
    return torch.stack([dz.sum(dim=(0, 2, 3)), (dz * xhat).sum(dim=(0, 2, 3))])


def backward_dx_reference(x, dy, saved, weight, bias, gsums, count: float, act: int) -> torch.Tensor:
    """dx = invstd * gamma * (dz - A / n - mask * xhat * B / n) in
    ``x.dtype``, (A, B) = ``gsums`` over every rank and n = ``count``."""
    dz, xhat = _grad_parts(x, dy, saved, weight, bias, act)
    a, b = gsums[0] / count, gsums[1] / count * saved[2]
    mul = saved[1] * weight
    return (_per_channel(mul) * (dz - _per_channel(a) - xhat * _per_channel(b))).to(x.dtype)


# ---------------------------------------------------------------------------
# Launch plans (plain Python).
# ---------------------------------------------------------------------------
def vector_width(c: int, elem: int, *tensors: torch.Tensor) -> int:
    """Channels a thread loads at once: the most, up to ``_MAX_VEC``, that
    divide C and keep every tensor's address aligned (4 at B5's widths; 2 at
    C = 38)."""
    for v in (_MAX_VEC, 2):
        if c % v == 0 and all(t.data_ptr() % (v * elem) == 0 for t in tensors):
            return v
    return 1


@functools.lru_cache(maxsize=None)
def plan(m: int, c: int, vec: int, sms: int) -> tuple[int, int, int, int]:
    """(Ct, R, tiles, nb): a pass over M rows of C channels, V = ``vec`` a
    thread. The C / V channel vectors split into as few tiles of at most
    ``_MAX_TILE`` as cover them, evenly; a block is R = 256 // Ct row lanes
    of a tile's Ct vectors, so each of its iterations reads R rows of the
    tile; nb blocks a tile, as many as the card holds at once (``sms`` SMs)
    and no more than the rows give. Narrow tiles keep a reduction's last
    step short: the last block of a tile adds nb partials of its Ct V
    channels only."""
    cv = c // vec
    tiles = -(-cv // _MAX_TILE)
    ct = -(-cv // tiles)
    r = _THREADS // ct
    nb = min(-(-m // r), max(1, -(-(sms * _BLOCKS_PER_SM) // tiles)))
    return ct, r, tiles, nb


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_tickets: dict[tuple[int | None, int], torch.Tensor] = {}
# Counters that a larger set replaced: a captured graph may still hold their
# addresses, so they are never freed.
_replaced_tickets: list[torch.Tensor] = []


def _ticket_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The reductions' ticket counters (one per channel tile) for launches on
    ``stream``: zeros, allocated once per (device, stream) and grown when a
    launch needs more; each launch leaves the counters it used at zero."""
    key = (device.index, stream)
    counters = _tickets.get(key)
    if counters is None or counters.numel() < n:
        if counters is not None:
            _replaced_tickets.append(counters)
        counters = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _tickets[key] = counters
    return counters


_kernel_fns: dict[str, object] = {}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# name -> argument types of s2_batchnorm_act_<name>
_ARGTYPES = {
    "stats": [_P] * 4 + [_L] + [_I] * 7 + [_P],
    "finalize": [_P] * 5 + [_I] + [_F] * 4 + [_I] * 2 + [_P],
    "apply": [_P] * 5 + [_L] + [_I] * 8 + [_P],
    "backward_sums": [_P] * 8 + [_L] + [_I] * 8 + [_P],
    "backward_dx": [_P] * 7 + [_L] + [_I] * 5 + [_F] + [_I] * 3 + [_P],
}


def _kernel(name: str):
    """The built library's C entry point ``s2_batchnorm_act_<name>`` (nvcc
    at first use)."""
    fn = _kernel_fns.get(name)
    if fn is None:
        from s2tpu_torch.ops._build import load_library

        fn = getattr(load_library("batchnorm_act", SOURCES), f"s2_batchnorm_act_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _kernel_fns[name] = fn
    return fn


def _launch(name: str, *args) -> None:
    err = _kernel(name)(*args)
    if err != 0:
        raise RuntimeError(f"batchnorm_act {name} kernel launch failed with CUDA error {err}")


def _rows(x: torch.Tensor) -> tuple[int, int]:
    """(M, C) of a channels-last (N, C, H, W) activation the kernels take."""
    if (x.dim() != 4 or x.dtype not in _DTYPE_CODES or x.numel() == 0
            or not x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"expected a non-empty channels-last (N, C, H, W) float32 or bfloat16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype} strides {x.stride()}")
    return x.numel() // x.shape[1], x.shape[1]


def _check_channel_tensors(c: int, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32 or t.shape[-1] != c or not t.is_contiguous() or t.device != tensors[0].device:
            raise ValueError(f"expected contiguous float32 (..., {c}) tensors on one device, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _row_plan(x: torch.Tensor, *tensors: torch.Tensor) -> tuple[int, int, int, int, int, int]:
    """(M, C, V, Ct, R, nb) of one pass over x (and the same-shaped tensors)."""
    m, c = _rows(x)
    vec = vector_width(c, x.element_size(), x, *tensors)
    ct, r, _, nb = plan(m, c, vec, _sms(x.device.index))
    return m, c, vec, ct, r, nb


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _reduction_buffers(x: torch.Tensor, c: int, vec: int, ct: int, nb: int, stream: int):
    """A reduction's f32 (2, C) sums, its (nb, 2, C) partials and its tiles'
    ticket counters."""
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    partial = torch.empty((nb, 2, c), dtype=torch.float32, device=x.device)
    return sums, partial, _ticket_counters(x.device, stream, -(-(c // vec) // ct))


# ---------------------------------------------------------------------------
# The custom ops.
# ---------------------------------------------------------------------------
@torch.library.custom_op("s2tpu_torch::batchnorm_act_stats", mutates_args=(), device_types="cpu")
def _stats_op(x: torch.Tensor) -> torch.Tensor:
    return stats_reference(x)


@_stats_op.register_kernel("cuda")
def _stats_cuda(x: torch.Tensor) -> torch.Tensor:
    m, c, vec, ct, r, nb = _row_plan(x)
    stream = _stream(x)
    sums, partial, tickets = _reduction_buffers(x, c, vec, ct, nb, stream)
    _launch("stats", x.data_ptr(), partial.data_ptr(), sums.data_ptr(), tickets.data_ptr(), m, c, vec, ct, r, nb,
            _DTYPE_CODES[x.dtype], x.device.index, stream)
    return sums


@_stats_op.register_fake
def _stats_fake(x: torch.Tensor) -> torch.Tensor:
    return x.new_empty((2, x.shape[1]), dtype=torch.float32)


@torch.library.custom_op(
    "s2tpu_torch::batchnorm_act_finalize", mutates_args=("running_mean", "running_var", "num_batches_tracked"),
    device_types="cpu",
)
def _finalize_op(
    sums: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor, num_batches_tracked: torch.Tensor,
    count: float, eps: float, decay: float, update: bool,
) -> torch.Tensor:
    return finalize_reference(sums, running_mean, running_var, num_batches_tracked, count, eps, decay, update)


@_finalize_op.register_kernel("cuda")
def _finalize_cuda(sums, running_mean, running_var, num_batches_tracked, count, eps, decay, update):
    c = sums.shape[1]
    _check_channel_tensors(c, sums, running_mean, running_var)
    if num_batches_tracked.dtype != torch.int64 or num_batches_tracked.numel() != 1:
        raise ValueError("num_batches_tracked must be one int64")
    saved = torch.empty((3, c), dtype=torch.float32, device=sums.device)
    _launch("finalize", sums.data_ptr(), saved.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
            num_batches_tracked.data_ptr(), c, count, eps, decay, 1.0 - decay, int(update), sums.device.index,
            _stream(sums))
    return saved


@_finalize_op.register_fake
def _finalize_fake(sums, running_mean, running_var, num_batches_tracked, count, eps, decay, update):
    return sums.new_empty((3, sums.shape[1]))


@torch.library.custom_op("s2tpu_torch::batchnorm_act_apply", mutates_args=(), device_types="cpu")
def _apply_op(x: torch.Tensor, saved: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              act: int) -> torch.Tensor:
    return apply_reference(x, saved, weight, bias, act)


@_apply_op.register_kernel("cuda")
def _apply_cuda(x, saved, weight, bias, act):
    global LAUNCHES
    y = torch.empty_like(x)
    m, c, vec, ct, r, nb = _row_plan(x, y)
    _check_channel_tensors(c, saved, weight, bias)
    _launch("apply", x.data_ptr(), saved.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), m, c, vec,
            ct, r, nb, act, _DTYPE_CODES[x.dtype], x.device.index, _stream(x))
    LAUNCHES += 1
    return y


@_apply_op.register_fake
def _apply_fake(x, saved, weight, bias, act):
    return torch.empty_like(x)


@torch.library.custom_op("s2tpu_torch::batchnorm_act_backward_sums", mutates_args=(), device_types="cpu")
def _backward_sums_op(x: torch.Tensor, dy: torch.Tensor, saved: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, act: int) -> torch.Tensor:
    return backward_sums_reference(x, dy, saved, weight, bias, act)


@_backward_sums_op.register_kernel("cuda")
def _backward_sums_cuda(x, dy, saved, weight, bias, act):
    _same_layout(x, dy)
    m, c, vec, ct, r, nb = _row_plan(x, dy)
    _check_channel_tensors(c, saved, weight, bias)
    stream = _stream(x)
    sums, partial, tickets = _reduction_buffers(x, c, vec, ct, nb, stream)
    _launch("backward_sums", x.data_ptr(), dy.data_ptr(), saved.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            partial.data_ptr(), sums.data_ptr(), tickets.data_ptr(), m, c, vec, ct, r, nb, act,
            _DTYPE_CODES[x.dtype], x.device.index, stream)
    return sums


@_backward_sums_op.register_fake
def _backward_sums_fake(x, dy, saved, weight, bias, act):
    return x.new_empty((2, x.shape[1]), dtype=torch.float32)


@torch.library.custom_op("s2tpu_torch::batchnorm_act_backward_dx", mutates_args=(), device_types="cpu")
def _backward_dx_op(x: torch.Tensor, dy: torch.Tensor, saved: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, gsums: torch.Tensor, count: float, act: int) -> torch.Tensor:
    return backward_dx_reference(x, dy, saved, weight, bias, gsums, count, act)


@_backward_dx_op.register_kernel("cuda")
def _backward_dx_cuda(x, dy, saved, weight, bias, gsums, count, act):
    _same_layout(x, dy)
    dx = torch.empty_like(x)
    m, c, vec, ct, r, nb = _row_plan(x, dy, dx)
    _check_channel_tensors(c, saved, weight, bias, gsums)
    _launch("backward_dx", x.data_ptr(), dy.data_ptr(), saved.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            gsums.data_ptr(), dx.data_ptr(), m, c, vec, ct, r, nb, count, act, _DTYPE_CODES[x.dtype],
            x.device.index, _stream(x))
    return dx


@_backward_dx_op.register_fake
def _backward_dx_fake(x, dy, saved, weight, bias, gsums, count, act):
    return torch.empty_like(x)


def _same_layout(x: torch.Tensor, dy: torch.Tensor) -> None:
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or dy.stride() != x.stride():
        raise ValueError(f"dy must match x in shape, dtype, device and strides: {tuple(dy.shape)} {dy.dtype} "
                         f"{dy.stride()} against {tuple(x.shape)} {x.dtype} {x.stride()}")


# ---------------------------------------------------------------------------
# The layer.
# ---------------------------------------------------------------------------
class BatchNormAct(torch.autograd.Function):
    """Train-mode BatchNorm and its activation through the five passes:
    stats, (the data axis's sum), finalize, apply; backward sums, (the data
    axis's sum), dx. Saves x and the (3, C) statistics. The affine runs on
    f32 copies of gamma and beta (C values each) whatever their storage
    dtype, as the plain form's f32 products promote them; their gradients
    come back in that dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked, eps: float, decay: float,
                act: int, data_axis: DataAxis, update: bool) -> torch.Tensor:
        count = float(x.numel() // x.shape[1] * data_axis.size)
        sums = data_axis.sum(torch.ops.s2tpu_torch.batchnorm_act_stats(x))
        saved = torch.ops.s2tpu_torch.batchnorm_act_finalize(
            sums, running_mean, running_var, num_batches_tracked, count, eps, decay, update)
        weight32, bias32 = weight.float(), bias.float()
        ctx.save_for_backward(x, weight32, bias32, saved)
        ctx.act, ctx.count, ctx.data_axis = act, count, data_axis
        ctx.dtypes = weight.dtype, bias.dtype
        return torch.ops.s2tpu_torch.batchnorm_act_apply(x, saved, weight32, bias32, act)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, weight, bias, saved = ctx.saved_tensors
        dy = dy.to(x.dtype)
        if dy.stride() != x.stride():  # x's layout, also where a size-1 dim leaves the strides free
            dy = torch.empty_like(x).copy_(dy)
        sums = torch.ops.s2tpu_torch.batchnorm_act_backward_sums(x, dy, saved, weight, bias, ctx.act)
        dx = None
        if ctx.needs_input_grad[0]:
            gsums = ctx.data_axis.sum(sums)
            dx = torch.ops.s2tpu_torch.batchnorm_act_backward_dx(x, dy, saved, weight, bias, gsums, ctx.count,
                                                                 ctx.act)
        dweight = sums[1].to(ctx.dtypes[0]) if ctx.needs_input_grad[1] else None
        dbias = sums[0].to(ctx.dtypes[1]) if ctx.needs_input_grad[2] else None
        return dx, dweight, dbias, None, None, None, None, None, None, None, None


def batchnorm_act(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
    running_var: torch.Tensor, num_batches_tracked: torch.Tensor, eps: float, decay: float, act: str = "none",
    data_axis: DataAxis = SINGLE, update: bool = True,
) -> torch.Tensor:
    """Train-mode BatchNorm of ``x`` (N, C, H, W) and its activation ``act``
    ("none", "silu" or "relu"), differentiable in x, weight and bias.

    On the card, :class:`BatchNormAct` (the kernels, on a channels-last copy
    of an ``x`` in another memory format; counted as ``batchnorm_fused`` by
    the profiling recorder); on the CPU, the plain autograd form,
    :func:`batchnorm_act_plain`. Both sum the statistics over ``data_axis``
    and, with ``update``, move the running statistics by ``decay``."""
    if act not in ACTIVATIONS:
        raise ValueError(f"activation {act!r} is not one of {sorted(ACTIVATIONS)}")
    if not x.is_cuda:
        return batchnorm_act_plain(x, weight, bias, running_mean, running_var, num_batches_tracked, eps, decay, act,
                                   data_axis, update)
    profiling.count("batchnorm_fused")
    return BatchNormAct.apply(x.contiguous(memory_format=torch.channels_last), weight, bias, running_mean,
                              running_var, num_batches_tracked, float(eps), float(decay), ACTIVATIONS[act], data_axis,
                              update)
