"""Attention for the Prithvi ViT: hand-written CUDA kernels for the fused
route (forward and backward, dense and head-major layouts) and the
streaming flash route (forward).

The port of ``s2tpu/ops/flash_attention.py``. Four functions reach a
kernel on the card:

- :func:`fused_attention_dense` ``(B, L, 3D) -> (B, L, D)``: whole-row
  attention on the raw ``nn.Linear(D, 3D)`` output, the head split done in
  the kernel (``csrc/fused_attention_dense.cu``, replacing the TPU kernels
  ``_fused_fwd_dense_kernel`` and ``_fused_bwd_dense_kernel``). Its autograd
  backward is a kernel too, with the JAX custom VJP's residuals (``qkv``
  and the output).
- :func:`fused_attention_qkv` ``(3, B, H, L, Dh) -> (B, H, L, Dh)``: the
  same attention on the packed head-major layout the tensor-parallel
  projection writes (the same CUDA kernels with other strides, replacing
  ``_fused_fwd_kernel`` and ``_fused_bwd_kernel``), with
  :func:`fused_attention_bhld` and :func:`fused_attention` on top.
- :func:`flash_attention` ``(B, L, H, Dh) x 3 -> (B, L, H, Dh)``: streaming
  online-softmax attention with f32 statistics and sums
  (``csrc/flash_attention.cu``, replacing ``_flash_kernel``). Its backward
  differentiates the plain attention
  (:func:`reference_attention`) with torch autograd, as the JAX package's
  custom VJP differentiates ``_reference_attention``: the TPU package has
  no backward kernel for it either.
- :func:`dot_product_attention`: plain torch with the semantics of
  ``jax.nn.dot_product_attention``, the route below ``FUSED_MIN_LEN``.

The route (:func:`attention_route`) is the JAX model's
(``s2tpu/models/prithvi_mae.py:240-291``), with the same constants and the
same ``fused_fits_vmem`` arithmetic: the TPU's scoped-VMEM budget decides
which shapes take the fused kernels, so a configuration runs the same
kernels on both machines. Each kernel has a plain PyTorch version beside it
that follows its algorithm and casts; the wrappers use it for CPU tensors
only. On a CUDA tensor a wrapper launches its kernel or raises.

Each kernel entry is a ``torch.library`` custom op (``s2tpu_torch::
fused_attention_dense_forward`` and ``..._backward``,
``fused_attention_qkv_forward`` and ``..._backward``,
``flash_attention_forward``): the CUDA implementation launches the
hand-written kernel, the CPU implementation is the plain version, a fake
version gives the output shapes (``torch.export`` traces the ViT through
them), and a FLOP formula lets ``FlopCounterMode`` count them.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

# Launches of the CUDA kernels (#8/#9 fused forward/backward on the dense
# layout, #6/#7 on the head-major layout, #5 flash forward); a run sets them
# to 0 and reads them. Only the CUDA branches of the wrappers add to them.
FUSED_FWD_LAUNCHES = 0
FUSED_BWD_LAUNCHES = 0
FUSED_QKV_FWD_LAUNCHES = 0
FUSED_QKV_BWD_LAUNCHES = 0
FLASH_FWD_LAUNCHES = 0

FUSED_SOURCES = ["fused_attention_dense.cu"]
FLASH_SOURCES = ["flash_attention.cu"]
KERNEL_HEAD_DIMS = (32, 64)  # head widths the kernels are built for

DEFAULT_BLOCK_K = 128  # the TPU flash kernel's key block; the plain version streams the same tiles
NEG_INF = -1e30
FUSED_MAX_LEN = 1024  # beyond this the fused score rows stop fitting
FUSED_MIN_LEN = 128  # below this the plain attention is already cheap
FLASH_MIN_LEN = 512  # the streaming route takes sequences from here on
SCOPED_VMEM_LIMIT = 16 * 1024 * 1024  # the TPU budget fused_fits_vmem is stated in


def fused_fits_vmem(l: int, dim: int, num_heads: int) -> bool:  # noqa: ARG001
    """The JAX package's budget test (``s2tpu/ops/flash_attention.py:180-196``):
    the fused backward's footprint, ``32·L·D`` bytes of blocks plus
    ``18·L²`` of score-shaped scratch, within 85 % of a 16 MiB TPU budget.
    The port keeps it as the route's rule, not as a limit of its kernels."""
    blocks = 32 * l * dim
    scratch = 18 * l * l
    return blocks + scratch <= int(SCOPED_VMEM_LIMIT * 0.85)


def attention_route(l: int, dim: int, num_heads: int, impl: str = "fused") -> str:
    """Which attention ``Attention`` runs at sequence length ``l``: "fused"
    (kernels #8/#9, or #6/#7 in the tensor-parallel form), "flash" (kernel
    #5) or "plain", as the JAX model chooses (``prithvi_mae.py:240-287``)."""
    if impl == "fused" and FUSED_MIN_LEN <= l <= FUSED_MAX_LEN and fused_fits_vmem(l, dim, num_heads):
        return "fused"
    if impl in ("fused", "flash") and l >= FLASH_MIN_LEN:
        return "flash"
    return "plain"


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _split_heads(x: torch.Tensor, num_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, L, 3D) -> q, k, v, each (B, H, L, Dh) views."""
    b, l, c3 = x.shape
    dh = c3 // 3 // num_heads
    parts = x.reshape(b, l, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    return parts[0], parts[1], parts[2]


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, D) -> (B, H, L, Dh) view."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, Dh) -> (B, L, H·Dh)."""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """f32 softmax of ``(q kᵀ)·scale`` over (B, H, L, Dh) operands: the
    products of input-type values, summed in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def _check_dense(qkv: torch.Tensor, num_heads: int) -> tuple[int, int, int, int]:
    """-> (B, L, D, Dh); raises on what the fused functions do not take."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(f"expected qkv (B, L, 3D) with D divisible by {num_heads} heads, got {tuple(qkv.shape)}")
    b, l, c3 = qkv.shape
    return b, l, c3 // 3, c3 // 3 // num_heads


def _check_qkv(qkv: torch.Tensor) -> tuple[int, int, int, int]:
    """-> (B, H, L, Dh) of a packed head-major qkv; raises on what
    :func:`fused_attention_qkv` does not take (JAX asserts L <= FUSED_MAX_LEN)."""
    if qkv.dim() != 5 or qkv.shape[0] != 3:
        raise ValueError(f"expected qkv (3, B, H, L, Dh), got {tuple(qkv.shape)}")
    _, b, h, l, dh = qkv.shape
    if not 1 <= l <= FUSED_MAX_LEN:
        raise ValueError(f"fused_attention_qkv takes 1 <= L <= {FUSED_MAX_LEN}, got L={l}; use flash_attention")
    return b, h, l, dh


def _attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The fused kernels' forward on (B, H, L, Dh) operands of one type:
    f32 scores of input-type operands times 1/√Dh, f32 softmax, the
    probabilities rounded to the input type, f32 sums of ``p·v``, the
    output in the input type."""
    p = _probs(q, k, 1.0 / math.sqrt(q.shape[-1]))
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def _attention_backward(q, k, v, out, dout) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused kernels' backward on (B, H, L, Dh) operands: p recomputed,
    ``dv = pcᵀ·do``, ``dp = do·vᵀ``, ``δ = rowsum(do∘o)``,
    ``ds = round(p(dp − δ)·scale)``, ``dq = ds·k``, ``dk = dsᵀ·q``; f32
    sums, returned in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, do = out.float(), dout.float()
    p = _probs(q, k, scale)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    return torch.matmul(ds, k.float()), torch.matmul(ds.transpose(-1, -2), q.float()), dv


def fused_attention_dense_forward_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch #8: ``(B, L, 3D) -> (B, L, D)`` as
    ``_fused_fwd_dense_kernel`` computes it (``flash_attention.py:324-349``)."""
    _check_dense(qkv, num_heads)
    return _merge_heads(_attention_forward(*_split_heads(qkv, num_heads)))


def fused_attention_dense_backward_reference(
    qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Plain PyTorch #9: ``dqkv (B, L, 3D)`` from the saved ``qkv``, the
    forward output ``out`` and its cotangent ``dout``, as
    ``_fused_bwd_dense_kernel`` computes it (``flash_attention.py:352-389``)."""
    _check_dense(qkv, num_heads)
    grads = _attention_backward(*_split_heads(qkv, num_heads), _heads(out, num_heads), _heads(dout, num_heads))
    return torch.cat([_merge_heads(t) for t in grads], dim=-1).to(qkv.dtype)


def fused_attention_qkv_forward_reference(qkv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch #6: ``(3, B, H, L, Dh) -> (B, H, L, Dh)`` as
    ``_fused_fwd_kernel`` computes it (``flash_attention.py:199-220``), cast
    for cast as #8."""
    _check_qkv(qkv)
    return _attention_forward(*qkv.unbind(0))


def fused_attention_qkv_backward_reference(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch #7: ``dqkv (3, B, H, L, Dh)`` from the saved ``qkv``,
    the forward output ``out`` and its cotangent ``dout`` (both (B, H, L,
    Dh)), as ``_fused_bwd_kernel`` computes it (``flash_attention.py:223-262``)."""
    _check_qkv(qkv)
    return torch.stack(_attention_backward(*qkv.unbind(0), out, dout)).to(qkv.dtype)


def flash_attention_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch #5 on (B, L, H, Dh): ``_flash_kernel``'s online softmax
    (``flash_attention.py:36-72``), f32 throughout, q scaled before the
    product, ``DEFAULT_BLOCK_K`` keys at a time. The short last block stands
    for the TPU kernel's padded keys, which it masks to exp(-1e30 - m) = 0."""
    l, dh = q.shape[1], q.shape[-1]
    qf = q.float().transpose(1, 2) * (1.0 / math.sqrt(dh))
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    m = torch.full((*qf.shape[:-1], 1), NEG_INF, dtype=torch.float32, device=q.device)
    den = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, l, DEFAULT_BLOCK_K):
        s = torch.matmul(qf, kf[:, :, k0 : k0 + DEFAULT_BLOCK_K].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        den = den * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vf[:, :, k0 : k0 + DEFAULT_BLOCK_K])
        m = m_new
    return (acc / den.clamp_min(1e-30)).to(q.dtype).transpose(1, 2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``_reference_attention`` (``flash_attention.py:113-118``) on
    (B, L, H, Dh): f32 scores divided by √Dh, softmax, f32 ``p·v``, cast to
    q's type. The flash route's backward differentiates this."""
    d = q.shape[-1]
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) / (d**0.5)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", p, v.float()).to(q.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.dot_product_attention(q, k, v)`` on (B, L, H, Dh) in plain
    torch (JAX 0.9 ``_dot_product_attention_core``): scores summed in f32
    from input-type operands, times 1/√Dh, f32 softmax, probabilities cast
    to v's type, f32 sums of ``p·v`` in v's type. Differentiable by autograd."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q.transpose(1, 2), k.transpose(1, 2), scale).to(v.dtype)
    o = torch.matmul(p.float(), v.transpose(1, 2).float()).to(v.dtype)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
_kernel_fns: dict[str, object] = {}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel(name: str):
    """The built library's C entry point ``s2_<name>`` (nvcc at first use)."""
    fn = _kernel_fns.get(name)
    if fn is None:
        from s2tpu_torch.ops._build import load_library

        if name.startswith("flash"):
            fn = load_library("flash_attention", FLASH_SOURCES).s2_flash_attention_fwd
            fn.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            )
        else:
            lib = load_library("fused_attention_dense", FUSED_SOURCES)
            fn = getattr(lib, f"s2_{name}")
            n_ptr = 2 if name.endswith("fwd") else 5
            fn.argtypes = (
                [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            )
        fn.restype = ctypes.c_int
        _kernel_fns[name] = fn
    return fn


def _check_cuda(t: torch.Tensor, what: str) -> int:
    """The kernels' dtype code of a CUDA tensor; raises on anything else."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def _check_head_dim(dh: int) -> None:
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the fused attention kernels take head width {KERNEL_HEAD_DIMS}, got {dh}")


def _check_fused_kernel_shape(l: int, d: int, dh: int, num_heads: int) -> None:
    _check_head_dim(dh)
    if not (FUSED_MIN_LEN <= l <= FUSED_MAX_LEN and fused_fits_vmem(l, d, num_heads)):
        raise ValueError(
            f"L={l}, D={d} is outside the fused route ({FUSED_MIN_LEN} <= L <= {FUSED_MAX_LEN} "
            "and fused_fits_vmem); use flash_attention"
        )


def _check_kernel_tensors(what: str, qkv: torch.Tensor, *others: torch.Tensor) -> None:
    """The fused kernels copy rows 16 bytes at a time from each tensor's
    start, and address every tensor but the batch axis with 32-bit offsets."""
    if qkv.numel() >= 2**31:
        raise ValueError(f"{what} takes qkv of fewer than 2^31 elements, got {qkv.numel()}")
    if any(t.data_ptr() % 16 for t in (qkv, *others)):
        raise ValueError(f"{what} needs 16-byte aligned tensors (a view at an odd offset? pass a copy)")


def _stream(t: torch.Tensor) -> tuple[int, int]:
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


# Each kernel entry is a custom op: the CUDA implementation launches the
# kernel, the CPU implementation is the plain version, the fake gives shapes.
def _op(name: str, cpu):
    return torch.library.custom_op(f"s2tpu_torch::{name}", cpu, mutates_args=(), device_types="cpu")


def _dense_fwd_cpu(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    return fused_attention_dense_forward_reference(qkv, num_heads)


def _dense_bwd_cpu(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor, num_heads: int) -> torch.Tensor:
    return fused_attention_dense_backward_reference(qkv, out, dout, num_heads)


def _qkv_fwd_cpu(qkv: torch.Tensor) -> torch.Tensor:
    return fused_attention_qkv_forward_reference(qkv)


def _qkv_bwd_cpu(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    return fused_attention_qkv_backward_reference(qkv, out, dout)


def _flash_fwd_cpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return flash_attention_forward_reference(q, k, v)


_dense_fwd_op = _op("fused_attention_dense_forward", _dense_fwd_cpu)
_dense_bwd_op = _op("fused_attention_dense_backward", _dense_bwd_cpu)
_qkv_fwd_op = _op("fused_attention_qkv_forward", _qkv_fwd_cpu)
_qkv_bwd_op = _op("fused_attention_qkv_backward", _qkv_bwd_cpu)
_flash_fwd_op = _op("flash_attention_forward", _flash_fwd_cpu)


@_dense_fwd_op.register_fake
def _(qkv, num_heads):
    b, l, c3 = qkv.shape
    return qkv.new_empty((b, l, c3 // 3))


@_dense_bwd_op.register_fake
@_qkv_bwd_op.register_fake
def _(qkv, out, dout, *args):
    return torch.empty_like(qkv)


@_qkv_fwd_op.register_fake
def _(qkv):
    return qkv.new_empty(qkv.shape[1:])


@_flash_fwd_op.register_fake
def _(q, k, v):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@_dense_fwd_op.register_kernel("cuda")
def _(qkv, num_heads):
    global FUSED_FWD_LAUNCHES
    b, l, d, dh = _check_dense(qkv, num_heads)
    code = _check_cuda(qkv, "fused_attention_dense")
    _check_fused_kernel_shape(l, d, dh, num_heads)
    if not qkv.is_contiguous():
        raise ValueError("fused_attention_dense reads qkv in place: pass a contiguous (B, L, 3D) tensor")
    _check_kernel_tensors("fused_attention_dense", qkv)
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    err = _kernel("fused_attention_dense_fwd")(
        qkv.data_ptr(), out.data_ptr(), b, l, num_heads, dh, 1.0 / math.sqrt(dh), code, *_stream(qkv)
    )
    if err != 0:
        raise RuntimeError(f"fused attention forward kernel launch failed with CUDA error {err}")
    FUSED_FWD_LAUNCHES += 1
    return out


@_dense_bwd_op.register_kernel("cuda")
def _(qkv, out, dout, num_heads):
    global FUSED_BWD_LAUNCHES
    b, l, d, dh = _check_dense(qkv, num_heads)
    code = _check_cuda(qkv, "fused_attention_dense backward")
    _check_fused_kernel_shape(l, d, dh, num_heads)
    qkv, out, dout = qkv.contiguous(), out.contiguous(), dout.contiguous()
    _check_kernel_tensors("fused_attention_dense backward", qkv, out, dout)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, b, num_heads, l), dtype=torch.float32, device=qkv.device)
    err = _kernel("fused_attention_dense_bwd")(
        qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        b, l, num_heads, dh, 1.0 / math.sqrt(dh), code, *_stream(qkv),
    )
    if err != 0:
        raise RuntimeError(f"fused attention backward kernel launch failed with CUDA error {err}")
    FUSED_BWD_LAUNCHES += 1
    return dqkv


@_qkv_fwd_op.register_kernel("cuda")
def _(qkv):
    global FUSED_QKV_FWD_LAUNCHES
    b, h, l, dh = _check_qkv(qkv)
    code = _check_cuda(qkv, "fused_attention_qkv")
    _check_head_dim(dh)
    if not qkv.is_contiguous():
        raise ValueError("fused_attention_qkv reads qkv in place: pass a contiguous (3, B, H, L, Dh) tensor")
    _check_kernel_tensors("fused_attention_qkv", qkv)
    out = torch.empty((b, h, l, dh), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    err = _kernel("fused_attention_qkv_fwd")(
        qkv.data_ptr(), out.data_ptr(), b, l, h, dh, 1.0 / math.sqrt(dh), code, *_stream(qkv)
    )
    if err != 0:
        raise RuntimeError(f"fused attention (head-major) forward kernel launch failed with CUDA error {err}")
    FUSED_QKV_FWD_LAUNCHES += 1
    return out


@_qkv_bwd_op.register_kernel("cuda")
def _(qkv, out, dout):
    global FUSED_QKV_BWD_LAUNCHES
    b, h, l, dh = _check_qkv(qkv)
    code = _check_cuda(qkv, "fused_attention_qkv backward")
    _check_head_dim(dh)
    qkv, out, dout = qkv.contiguous(), out.contiguous(), dout.contiguous()
    _check_kernel_tensors("fused_attention_qkv backward", qkv, out, dout)
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    stats = torch.empty((3, b, h, l), dtype=torch.float32, device=qkv.device)
    err = _kernel("fused_attention_qkv_bwd")(
        qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        b, l, h, dh, 1.0 / math.sqrt(dh), code, *_stream(qkv),
    )
    if err != 0:
        raise RuntimeError(f"fused attention (head-major) backward kernel launch failed with CUDA error {err}")
    FUSED_QKV_BWD_LAUNCHES += 1
    return dqkv


@_flash_fwd_op.register_kernel("cuda")
def _(q, k, v):
    global FLASH_FWD_LAUNCHES
    code = _check_cuda(q, "flash_attention")
    b, l, h, dh = q.shape
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash attention kernel takes head width {KERNEL_HEAD_DIMS}, got {dh}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs q, k, v with a contiguous last axis")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError(
            "flash_attention (bf16) needs q, k, v starting 16-byte aligned with batch, token and head strides "
            "that are multiples of 8 elements (pass copies)"
        )
    out = torch.empty((b, l, h, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1), t.stride(2))]
    err = _kernel("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        b, l, h, dh, 1.0 / math.sqrt(dh), code, *_stream(q),
    )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed with CUDA error {err}")
    FLASH_FWD_LAUNCHES += 1
    return out


# FLOP formulas for FlopCounterMode (a step's operations, counted by shape): the
# algorithm's products, 2 L^2 Dh operations a (batch, head) for each of
# q k^T and p v forward, and four such products backward (dv, dp, dq, dk),
# as PyTorch counts scaled_dot_product_attention.
def _attention_flops(b: int, h: int, l: int, dh: int, products: int) -> int:
    return products * 2 * b * h * l * l * dh


register_flop_formula(torch.ops.s2tpu_torch.fused_attention_dense_forward)(
    lambda qkv_shape, num_heads, out_shape=None, **kw: _attention_flops(
        qkv_shape[0], num_heads, qkv_shape[1], qkv_shape[2] // 3 // num_heads, 2)
)
register_flop_formula(torch.ops.s2tpu_torch.fused_attention_dense_backward)(
    lambda qkv_shape, out_shape_, dout_shape, num_heads, out_shape=None, **kw: _attention_flops(
        qkv_shape[0], num_heads, qkv_shape[1], qkv_shape[2] // 3 // num_heads, 4)
)
register_flop_formula(torch.ops.s2tpu_torch.fused_attention_qkv_forward)(
    lambda qkv_shape, out_shape=None, **kw: _attention_flops(*qkv_shape[1:], 2)
)
register_flop_formula(torch.ops.s2tpu_torch.fused_attention_qkv_backward)(
    lambda qkv_shape, o_shape, do_shape, out_shape=None, **kw: _attention_flops(*qkv_shape[1:], 4)
)
register_flop_formula(torch.ops.s2tpu_torch.flash_attention_forward)(
    lambda q_shape, k_shape, v_shape, out_shape=None, **kw: _attention_flops(
        q_shape[0], q_shape[2], q_shape[1], q_shape[3], 2)
)


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def fused_attention_dense_forward(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``(B, L, 3D) -> (B, L, D)`` fused attention, no autograd.

    Ports ``s2tpu/ops/flash_attention.py::_fused_fwd_dense`` (``:449-470``,
    TPU kernel ``_fused_fwd_dense_kernel`` ``:324``) as the custom op
    ``s2tpu_torch::fused_attention_dense_forward``. A CUDA tensor goes
    through kernel #8, launched on the current stream without
    synchronising; it must be contiguous, f32 or bf16, with Dh 32 or 64 and
    a length on the fused route. A CPU tensor goes through the plain version."""
    _check_dense(qkv, num_heads)
    _check_device(qkv, "fused_attention_dense")
    return torch.ops.s2tpu_torch.fused_attention_dense_forward(qkv, num_heads)


def fused_attention_dense_backward(
    qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """``dqkv (B, L, 3D)`` of :func:`fused_attention_dense` from its saved
    ``qkv``, its output ``out`` and the output's cotangent ``dout``.

    Ports ``s2tpu/ops/flash_attention.py::_fused_bwd_dense`` (``:473-488``,
    TPU kernel ``_fused_bwd_dense_kernel`` ``:352``) as the custom op
    ``s2tpu_torch::fused_attention_dense_backward``. A CUDA tensor goes
    through kernel #9 (bf16: dq blocks that also write the rows'
    statistics, then dk/dv blocks; f32: a statistics pass, then dk/dv and
    dq blocks; no atomics), launched on the current stream without
    synchronising; a CPU tensor through the plain version."""
    b, l, d, _ = _check_dense(qkv, num_heads)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != (b, l, d) or t.dtype != qkv.dtype or t.device != qkv.device:
            raise ValueError(f"{name} must be {(b, l, d)} {qkv.dtype} on {qkv.device}, got {tuple(t.shape)} {t.dtype}")
    _check_device(qkv, "fused_attention_dense backward")
    return torch.ops.s2tpu_torch.fused_attention_dense_backward(qkv, out, dout, num_heads)


def fused_attention_qkv_forward(qkv: torch.Tensor) -> torch.Tensor:
    """``(3, B, H, L, Dh) -> (B, H, L, Dh)`` fused attention, no autograd.

    Ports ``s2tpu/ops/flash_attention.py::_fused_fwd_qkv`` (``:287-301``,
    TPU kernel ``_fused_fwd_kernel`` ``:199``) as the custom op
    ``s2tpu_torch::fused_attention_qkv_forward``. A CUDA tensor goes through
    kernel #6 (the #8 kernels on head-major strides), launched on the
    current stream without synchronising; it must be contiguous, f32 or
    bf16, with Dh 32 or 64. Any 1 <= L <= FUSED_MAX_LEN runs, on or off the
    fused route, as in JAX. A CPU tensor goes through the plain version."""
    _check_qkv(qkv)
    _check_device(qkv, "fused_attention_qkv")
    return torch.ops.s2tpu_torch.fused_attention_qkv_forward(qkv)


def fused_attention_qkv_backward(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``dqkv (3, B, H, L, Dh)`` of :func:`fused_attention_qkv` from its saved
    ``qkv``, its output ``out`` and the output's cotangent ``dout``.

    Ports ``s2tpu/ops/flash_attention.py::_fused_bwd_qkv`` (``:304-318``,
    TPU kernel ``_fused_bwd_kernel`` ``:223``) as the custom op
    ``s2tpu_torch::fused_attention_qkv_backward``. A CUDA tensor goes
    through kernel #7 (the #9 kernels on head-major strides, no atomics),
    launched on the current stream without synchronising; a CPU tensor
    through the plain version."""
    b, h, l, dh = _check_qkv(qkv)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != (b, h, l, dh) or t.dtype != qkv.dtype or t.device != qkv.device:
            raise ValueError(f"{name} must be {(b, h, l, dh)} {qkv.dtype} on {qkv.device}, got {tuple(t.shape)} {t.dtype}")
    _check_device(qkv, "fused_attention_qkv backward")
    return torch.ops.s2tpu_torch.fused_attention_qkv_backward(qkv, out, dout)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, L, H, Dh) q, k, v -> (B, L, H, Dh) streaming attention, no autograd.

    Ports ``s2tpu/ops/flash_attention.py::_flash_forward`` (``:85-110``, TPU
    kernel ``_flash_kernel`` ``:36``) as the custom op
    ``s2tpu_torch::flash_attention_forward``. A CUDA tensor goes through
    kernel #5, launched on the current stream without synchronising; q, k
    and v may be strided views (the last axis contiguous), f32 or bf16, Dh
    32 or 64. The bf16 kernel copies rows 16 bytes at a time: each view
    must start 16-byte aligned, with batch, token and head strides that are
    multiples of 8 elements (the views of one (B, L, 3D) projection that
    Attention hands over are). A CPU tensor goes through the plain version."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one (B, L, H, Dh) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype and q.device == k.device == v.device):
        raise ValueError("q, k and v must share a dtype and a device")
    _check_device(q, "flash_attention")
    return torch.ops.s2tpu_torch.flash_attention_forward(q, k, v)


# ---------------------------------------------------------------------------
# differentiable ops
# ---------------------------------------------------------------------------
class FusedAttentionDense(torch.autograd.Function):
    """The JAX custom VJP ``fused_attention_dense`` (``:434-491``): forward
    kernel #8, backward kernel #9; saves ``qkv`` and the output."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        out = fused_attention_dense_forward(qkv, num_heads)
        ctx.save_for_backward(qkv, out)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out = ctx.saved_tensors
        return fused_attention_dense_backward(qkv, out, dout.to(qkv.dtype), ctx.num_heads), None


class FusedAttentionQKV(torch.autograd.Function):
    """The JAX custom VJP ``fused_attention_qkv`` (``:273-321``): forward
    kernel #6, backward kernel #7; saves ``qkv`` and the output, the JAX
    residuals (``:301``)."""

    @staticmethod
    def forward(ctx, qkv):
        out = fused_attention_qkv_forward(qkv)
        ctx.save_for_backward(qkv, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out = ctx.saved_tensors
        return fused_attention_qkv_backward(qkv, out, dout.to(qkv.dtype))


class FlashAttention(torch.autograd.Function):
    """The JAX custom VJP ``flash_attention`` (``:121-146``): forward kernel
    #5; backward differentiates :func:`reference_attention` (recomputed)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention_forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = reference_attention(*leaves)
            return torch.autograd.grad(out, leaves, g)


def fused_attention_dense(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Fused attention on the raw ``(B, L, 3D)`` qkv projection -> (B, L, D)."""
    return FusedAttentionDense.apply(qkv, num_heads)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Streaming attention, (B, L, H, Dh) q, k, v -> (B, L, H, Dh)."""
    return FlashAttention.apply(q, k, v)


def fused_attention_qkv(qkv: torch.Tensor) -> torch.Tensor:
    """Fused attention on a packed head-major ``(3, B, H, L, Dh)`` qkv ->
    (B, H, L, Dh), L <= FUSED_MAX_LEN."""
    return FusedAttentionQKV.apply(qkv)


def fused_attention_bhld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, L, Dh) q, k, v -> (B, H, L, Dh) through :func:`fused_attention_qkv`."""
    return fused_attention_qkv(torch.stack([q, k, v]))


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, L, H, Dh) q, k, v -> (B, L, H, Dh) through :func:`fused_attention_qkv`."""
    out = fused_attention_bhld(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2)
