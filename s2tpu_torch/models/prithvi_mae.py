"""Prithvi-100M ViT masked autoencoder in PyTorch: the port of ``s2tpu/models/prithvi_mae.py``.

The published NASA/IBM Prithvi-100M MAE: fixed 3D sincos position tables
(6/6/4 sixteenths of the width for w/h/t), tubelet patch embedding as a
patchify + one dense product, per-sample argsort-of-noise masking with a
static keep count, a pre-norm ViT encoder and decoder, and the MSE of the
masked patches. Inputs are (B, T, H, W, C), channel-last, as in JAX.

Module and parameter names are the published checkpoint's
(``patch_embed.proj``, ``cls_token``, ``blocks.{i}.norm1`` / ``.attn.qkv`` /
``.attn.proj`` / ``.norm2`` / ``.mlp.fc1`` / ``.mlp.fc2``, ``norm``,
``decoder_embed``, ``mask_token``, ``decoder_blocks.{i}.*``,
``decoder_norm``, ``decoder_pred``), so ``Prithvi_100M.pt`` and the JAX
package's ``export_prithvi_state_dict`` load with ``strict=True``. The
position tables are fixed buffers outside the state dict; an incoming
``pos_embed`` / ``decoder_pos_embed`` is checked against them when its grid
matches and ignored when it does not, as the reference's weight surgery
regenerates them.

Numerics follow flax: parameters are stored in f32 and cast to the compute
dtype where they are used; LayerNorm takes f32 statistics as
E[x²] - E[x]² (clipped at 0) with eps 1e-5 and returns the compute dtype;
GELU is exact (erf). Attention takes the JAX model's route
(:func:`s2tpu_torch.ops.flash_attention.attention_route`): the fused
kernels #8/#9 where the fused route holds, the streaming kernel #5 for long
sequences, plain attention below 128 tokens.

``PrithviConfig(tp_axis=...)`` builds the tensor-parallel form
(``prithvi_mae.py:264-291``): the q/k/v projection writes the head-major
(3, B, H, L, Dh) layout (:class:`QKVEinsum`) that the fused kernels #6/#7
read, and the output projection contracts (H, Dh) jointly
(:class:`ProjEinsum`). Given the mesh's 'model' process group of n ranks,
rank r runs heads [r·H/n, (r+1)·H/n) and MLP hidden columns
[r·4D/n, (r+1)·4D/n) from its slices of the replicated parameters, with
Megatron's pair of collectives around each block half. The parameter names
and shapes are the dense model's, so the two load each other's state
dicts. On a 2-D ('data', 'model') mesh the model group is the mesh's
'model' group and the batch is split over 'data' (``data_axis``: the
loss's masked-patch denominator is the global batch's).

``PrithviConfig(cp_axis=...)`` is context parallelism over the same group
(``prithvi_mae.py:98-104``, ``:304-328``): between the blocks each rank
holds its share of the tokens, padded to ``n·⌈L/n⌉`` so that the shares are
equal (``L`` is odd with the cls token), and its LayerNorms and residual
adds run on its own tokens; the pad rows are cut off before any attention
and their gradient is zero. Two forms, as in the JAX model:

- ``tp_axis == cp_axis``: Megatron's sequence parallelism over the
  tensor-parallel block. The normed tokens are all-gathered before the q/k/v
  projection and before ``fc1`` (the backward reduce-scatters), the
  partial outputs of ``proj`` and ``fc2`` are reduce-scattered over the
  tokens in place of the all-reduce, and their biases added once after it.
- ``cp_axis`` alone (gather-KV): each rank keeps its tokens through the
  MLP; attention gathers the normed tokens, runs the dense model's route
  over the whole sequence and keeps this rank's rows for ``proj``.

The LayerNorms', the post-scatter biases' (and in the gather-KV form every
block parameter's) gradients then cover only this rank's tokens:
:meth:`PrithviMAE.token_shard_parameters` names them, and the trainer sums
their gradients over the model group in one bucketed all-reduce after the
backward (``ModelAxis.all_reduce_flat_``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from s2tpu_torch.models.remat import checkpointed
from s2tpu_torch.ops.flash_attention import (
    attention_route,
    dot_product_attention,
    flash_attention,
    fused_attention_dense,
    fused_attention_qkv,
)
from s2tpu_torch.parallel.mesh import MODEL_AXIS, SINGLE, ModelAxis
from s2tpu_torch.parallel.pipeline import Pipeline, check_pipeline, pipelined_block_apply, pipelined_stacks
from s2tpu_torch.train.losses import mae_reconstruction_loss

LECUN_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to (-2, 2)


# ---------------------------------------------------------------------------
# sincos position embeddings (numpy, computed once)
# ---------------------------------------------------------------------------
def sincos_1d(embed_dim: int, positions: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim) [sin | cos] embedding."""
    assert embed_dim % 2 == 0
    omega = 1.0 / 10000 ** (np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0))
    angles = np.outer(positions.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(angles), np.cos(angles)], axis=1)


def sincos_3d(embed_dim: int, grid_size: tuple[int, int, int], cls_token: bool = False) -> np.ndarray:
    """3D (t, h, w) sincos table, (t·h·w [+1], embed_dim) f32: widths split
    6/6/4 sixteenths for w/h/t, tiled in token order (t, h, w)."""
    assert embed_dim % 16 == 0
    t, h, w = grid_size
    dim_w = dim_h = embed_dim // 16 * 6
    dim_t = embed_dim // 16 * 4
    emb_w = np.tile(sincos_1d(dim_w, np.arange(w)), (t * h, 1))
    emb_h = np.tile(np.repeat(sincos_1d(dim_h, np.arange(h)), w, axis=0), (t, 1))
    emb_t = np.repeat(sincos_1d(dim_t, np.arange(t)), h * w, axis=0)
    pos = np.concatenate([emb_w, emb_h, emb_t], axis=1)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos.astype(np.float32)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PrithviConfig:
    """The JAX model's config. ``tp_axis`` names the mesh axis the heads and
    MLP hidden are split over, ``cp_axis`` the axis the tokens are split
    over between the blocks (None: the dense form); the port has one such
    axis, the mesh's 'model' axis, and refuses any other name.
    ``dp_axis`` names the batch axis, the mesh's 'data' axis; the port takes
    no other value (ROADMAP A16)."""

    img_size: int = 224
    patch_size: int = 16
    num_frames: int = 1
    tubelet_size: int = 1
    in_chans: int = 6
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    decoder_embed_dim: int = 512
    decoder_depth: int = 8
    decoder_num_heads: int = 16
    mlp_ratio: float = 4.0
    norm_pix_loss: bool = False
    layer_norm_eps: float = 1e-5
    attention_impl: str = "xla"  # "xla" (plain), "flash" or "fused"
    tp_axis: str | None = None
    dp_axis: str | None = "data"
    cp_axis: str | None = None

    @property
    def grid_size(self) -> tuple[int, int, int]:
        return (self.num_frames // self.tubelet_size, self.img_size // self.patch_size, self.img_size // self.patch_size)

    @property
    def num_patches(self) -> int:
        t, h, w = self.grid_size
        return t * h * w

    @property
    def patch_dim(self) -> int:
        return self.tubelet_size * self.patch_size * self.patch_size * self.in_chans

    @staticmethod
    def from_model_args(args: dict, **overrides) -> "PrithviConfig":
        """From the published config's ``model_args`` (``utils.load_prithvi_model_args``)."""
        merged = {**args, **overrides}
        keys = ("img_size", "patch_size", "num_frames", "tubelet_size", "in_chans", "embed_dim", "depth",
                "num_heads", "decoder_embed_dim", "decoder_depth", "decoder_num_heads")
        return PrithviConfig(**{k: merged[k] for k in keys})


# ---------------------------------------------------------------------------
# patchify / unpatchify
# ---------------------------------------------------------------------------
def patchify(imgs: torch.Tensor, patch: int, tubelet: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, L, tub·p·p·C), tokens in (t, h, w) order, each
    token's features in (tub, p, q, c) order (channel fastest)."""
    b, t, h, w, c = imgs.shape
    gt, gh, gw = t // tubelet, h // patch, w // patch
    x = imgs.reshape(b, gt, tubelet, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)  # b gt gh gw tub p q c
    return x.reshape(b, gt * gh * gw, tubelet * patch * patch * c)


def unpatchify(tokens: torch.Tensor, grid: tuple[int, int, int], patch: int, tubelet: int, channels: int) -> torch.Tensor:
    """(B, L, tub·p·p·C) -> (B, T, H, W, C), the inverse of :func:`patchify`."""
    b = tokens.shape[0]
    gt, gh, gw = grid
    x = tokens.reshape(b, gt, gh, gw, tubelet, patch, patch, channels)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)  # b gt tub gh p gw q c
    return x.reshape(b, gt * tubelet, gh * patch, gw * patch, channels)


# ---------------------------------------------------------------------------
# layers (parameters in f32, cast to the input's dtype where used)
# ---------------------------------------------------------------------------
def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal`` on a (out, in) weight: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / LECUN_TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


class Linear(nn.Linear):
    """``nn.Dense`` with flax's default init (lecun normal, zero bias); the
    weight and bias are cast to the input's dtype."""

    def __init__(self, cin: int, cout: int, generator: torch.Generator) -> None:
        super().__init__(cin, cout)
        with torch.no_grad():
            _lecun_normal_(self.weight, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: f32 mean and E[x²] - E[x]² (clipped at 0),
    ``(x - mean) · (rsqrt(var + eps) · scale) + bias`` in f32, returned in
    the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention with the JAX model's route (``:226-291``):
    ``qkv`` and ``proj`` are plain dense layers and the kernels read the
    ``(B, L, 3D)`` projection in place."""

    def __init__(self, dim: int, num_heads: int, impl: str, generator: torch.Generator) -> None:
        super().__init__()
        self.dim, self.num_heads, self.impl = dim, num_heads, impl
        self.qkv = Linear(dim, 3 * dim, generator)
        self.proj = Linear(dim, dim, generator)

    def core(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, D) -> the heads' outputs (B, L, D), before ``proj``."""
        b, l, _ = x.shape
        qkv = self.qkv(x)
        route = attention_route(l, self.dim, self.num_heads, self.impl)
        if route == "fused":
            return fused_attention_dense(qkv, self.num_heads)
        q, k, v = qkv.reshape(b, l, 3, self.num_heads, self.dim // self.num_heads).unbind(2)
        out = flash_attention(q, k, v) if route == "flash" else dot_product_attention(q, k, v)
        return out.reshape(b, l, self.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.core(x))

    def on_tokens(self, y: torch.Tensor, axis: ModelAxis, length: int) -> torch.Tensor:
        """Gather-KV context parallelism: this rank's normed token share
        ``y`` -> its rows of the attention output. The whole sequence's
        attention runs on every rank; ``proj`` only on this rank's rows."""
        whole = axis.gather_summed(y, 1)[:, :length]
        return self.proj(axis.local(_pad_tokens(self.core(whole), axis.size), 1))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, generator: torch.Generator) -> None:
        super().__init__()
        self.fc1 = Linear(dim, hidden, generator)
        self.fc2 = Linear(hidden, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))

    def on_tokens(self, y: torch.Tensor, axis: ModelAxis, length: int) -> torch.Tensor:
        """Gather-KV context parallelism: the MLP of this rank's tokens."""
        del axis, length
        return self(y)


# ---------------------------------------------------------------------------
# tensor parallelism over a process group (None: one rank, no collectives)
# ---------------------------------------------------------------------------
class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the group
    backward (each rank's gradient covers only the work of its shard)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the ranks' partial sums all-reduced forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def _pad_tokens(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, L, D) -> (B, n·⌈L/n⌉, D), zero rows after the last token."""
    return F.pad(x, (0, 0, 0, -x.shape[1] % n))


def _reduce_scatter_tokens(partial: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The ranks' partial (B, L, D) outputs summed, this rank's share of the
    padded tokens kept."""
    return axis.reduce_scatter(_pad_tokens(partial, axis.size), 1)


def _shard(n_items: int, group, what: str) -> slice:
    """This rank's contiguous share of ``n_items`` over ``group``."""
    rank, size = (dist.get_rank(group), dist.get_world_size(group)) if group is not None else (0, 1)
    if n_items % size:
        raise ValueError(f"{n_items} {what} do not split over a model axis of {size} ranks")
    per = n_items // size
    return slice(rank * per, (rank + 1) * per)


class QKVEinsum(Linear):
    """``_QKVEinsum`` (``prithvi_mae.py:182-205``): the q/k/v projection
    straight into the head-major (3, B, H, L, Dh) layout, bias broadcast
    after the product. Its parameters are ``nn.Linear(dim, 3·dim)``'s
    (names, shapes, flax init). Over ``group`` this rank projects only its
    heads, from its rows of the replicated weight; the weight's gradient is
    summed over the group."""

    def __init__(self, dim: int, num_heads: int, generator: torch.Generator, group=None) -> None:
        super().__init__(dim, 3 * dim, generator)
        self.num_heads, self.group = num_heads, group
        self.heads = _shard(num_heads, group, "heads")

    def _local(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's (3, H_r, Dh, D) weight and (3, H_r, Dh) bias in ``dtype``."""
        d = self.in_features
        w = copy_to_group(self.weight, self.group).view(3, self.num_heads, d // self.num_heads, d)[:, self.heads]
        b = copy_to_group(self.bias, self.group).view(3, self.num_heads, -1)[:, self.heads]
        return w.to(dtype), b.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, D) -> contiguous (3, B, H_r, L, Dh)."""
        w, b = self._local(x.dtype)
        return (torch.einsum("bli,phdi->pbhld", x, w) + b[:, None, :, None, :]).contiguous()

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, D) -> (B, L, 3·H_r·Dh), the dense layout of this rank's heads."""
        w, b = self._local(x.dtype)
        return F.linear(x, w.reshape(-1, self.in_features), b.reshape(-1))


class ProjEinsum(Linear):
    """``_ProjEinsum`` (``prithvi_mae.py:208-223``): the output projection
    contracting (H, Dh) jointly, from the head-major (B, H, L, Dh) layout,
    with ``nn.Linear(dim, dim)``'s parameters. Over ``group`` this rank
    contracts its heads' columns; the partial products are summed over the
    group and the bias is added once, after the sum."""

    def __init__(self, dim: int, num_heads: int, generator: torch.Generator, group=None) -> None:
        super().__init__(dim, dim, generator)
        self.num_heads, self.group = num_heads, group
        self.heads = _shard(num_heads, group, "heads")

    def _local(self, dtype: torch.dtype) -> torch.Tensor:
        """This rank's (D, H_r, Dh) weight columns in ``dtype``."""
        d = self.in_features
        return copy_to_group(self.weight, self.group).view(d, self.num_heads, -1)[:, self.heads].to(dtype)

    def partial(self, x_bhld: torch.Tensor) -> torch.Tensor:
        """(B, H_r, L, Dh) -> this rank's heads' share of the (B, L, D)
        output, before the sum and the bias."""
        return torch.einsum("bhld,ohd->blo", x_bhld, self._local(x_bhld.dtype))

    def partial_dense(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, H_r·Dh) -> this rank's share, before the sum and the bias."""
        return F.linear(x, self._local(x.dtype).reshape(self.out_features, -1))

    def forward(self, x_bhld: torch.Tensor) -> torch.Tensor:
        """(B, H_r, L, Dh) -> (B, L, D)."""
        return reduce_from_group(self.partial(x_bhld), self.group) + self.bias.to(x_bhld.dtype)

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, H_r·Dh) -> (B, L, D)."""
        return reduce_from_group(self.partial_dense(x), self.group) + self.bias.to(x.dtype)


class TensorParallelAttention(nn.Module):
    """``Attention`` with ``tp_axis`` set (``prithvi_mae.py:264-291``): the
    fused route through :class:`QKVEinsum`, kernels #6/#7 and
    :class:`ProjEinsum`; the other routes project densely, as the JAX
    model does, over this rank's heads."""

    def __init__(self, dim: int, num_heads: int, impl: str, generator: torch.Generator, group=None) -> None:
        super().__init__()
        self.dim, self.num_heads, self.impl, self.group = dim, num_heads, impl, group
        self.qkv = QKVEinsum(dim, num_heads, generator, group)
        self.proj = ProjEinsum(dim, num_heads, generator, group)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, D) -> this rank's heads' share of the output, before the
        sum over the group and ``proj``'s bias."""
        b, l, _ = x.shape
        route = attention_route(l, self.dim, self.num_heads, self.impl)
        if route == "fused":
            return self.proj.partial(fused_attention_qkv(self.qkv(x)))
        q, k, v = self.qkv.dense(x).reshape(b, l, 3, -1, self.dim // self.num_heads).unbind(2)
        out = flash_attention(q, k, v) if route == "flash" else dot_product_attention(q, k, v)
        return self.proj.partial_dense(out.reshape(b, l, -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        partial = self.partial(copy_to_group(x, self.group))
        return reduce_from_group(partial, self.group) + self.proj.bias.to(x.dtype)

    def on_tokens(self, y: torch.Tensor, axis: ModelAxis, length: int) -> torch.Tensor:
        """Sequence parallelism: this rank's normed token share ``y`` ->
        its share of the output: the tokens all-gathered (the backward
        reduce-scatters), the heads' partial outputs reduce-scattered over
        the tokens, ``proj``'s bias added after."""
        partial = self.partial(axis.gather_summed(y, 1)[:, :length])
        return _reduce_scatter_tokens(partial, axis) + self.proj.bias.to(y.dtype)


class TensorParallelMlp(Mlp):
    """The MLP with its hidden columns split over ``group``: this rank's
    rows of fc1 and columns of fc2, the partial outputs summed over the
    group, fc2's bias added once after the sum."""

    def __init__(self, dim: int, hidden: int, generator: torch.Generator, group=None) -> None:
        super().__init__(dim, hidden, generator)
        self.group = group
        self.cols = _shard(hidden, group, "MLP hidden units")

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's hidden columns' share of the output, before the sum
        over the group and fc2's bias."""
        w1 = copy_to_group(self.fc1.weight, self.group)[self.cols].to(x.dtype)
        b1 = copy_to_group(self.fc1.bias, self.group)[self.cols].to(x.dtype)
        w2 = copy_to_group(self.fc2.weight, self.group)[:, self.cols].to(x.dtype)
        return F.linear(F.gelu(F.linear(x, w1, b1), approximate="none"), w2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        partial = self.partial(copy_to_group(x, self.group))
        return reduce_from_group(partial, self.group) + self.fc2.bias.to(x.dtype)

    def on_tokens(self, y: torch.Tensor, axis: ModelAxis, length: int) -> torch.Tensor:
        """Sequence parallelism, as :meth:`TensorParallelAttention.on_tokens`."""
        partial = self.partial(axis.gather_summed(y, 1)[:, :length])
        return _reduce_scatter_tokens(partial, axis) + self.fc2.bias.to(y.dtype)


class Block(nn.Module):
    """Pre-norm ViT block: LN - attention - residual, LN - MLP - residual;
    the tensor-parallel form over ``group`` when ``tensor_parallel``. Given
    a ``context`` (the model axis), ``x`` is this rank's share of ``length``
    tokens (context parallelism, :meth:`PrithviMAE._run_blocks`)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, impl: str, eps: float,
                 generator: torch.Generator, tensor_parallel: bool = False, group=None) -> None:
        super().__init__()
        self.tensor_parallel = tensor_parallel
        self.norm1 = LayerNorm(dim, eps=eps)
        if tensor_parallel:
            self.attn = TensorParallelAttention(dim, num_heads, impl, generator, group)
        else:
            self.attn = Attention(dim, num_heads, impl, generator)
        self.norm2 = LayerNorm(dim, eps=eps)
        if tensor_parallel:
            self.mlp = TensorParallelMlp(dim, int(dim * mlp_ratio), generator, group)
        else:
            self.mlp = Mlp(dim, int(dim * mlp_ratio), generator)

    def forward(self, x: torch.Tensor, context: ModelAxis | None = None, length: int = 0) -> torch.Tensor:
        if context is None:
            x = x + self.attn(self.norm1(x))
            return x + self.mlp(self.norm2(x))
        x = x + self.attn.on_tokens(self.norm1(x), context, length)
        return x + self.mlp.on_tokens(self.norm2(x), context, length)

    def token_shard_parameters(self) -> list[nn.Parameter]:
        """Under context parallelism, the parameters whose gradients cover
        only this rank's tokens: the LayerNorms' and the biases added after
        the reduce-scatter; in the gather-KV form every parameter."""
        if not self.tensor_parallel:
            return list(self.parameters())
        return [*self.norm1.parameters(), *self.norm2.parameters(), self.attn.proj.bias, self.mlp.fc2.bias]


class PatchEmbed(nn.Module):
    """Tubelet patch embedding held as the published Conv3d weight
    (D, C, tub, p, p) and applied as patchify + one dense product (stride
    equals kernel, so the two agree)."""

    def __init__(self, cfg: PrithviConfig, generator: torch.Generator) -> None:
        super().__init__()
        self.patch, self.tubelet = cfg.patch_size, cfg.tubelet_size
        shape = (cfg.embed_dim, cfg.in_chans, cfg.tubelet_size, cfg.patch_size, cfg.patch_size)
        self.proj = nn.Conv3d(cfg.in_chans, cfg.embed_dim, shape[2:], stride=shape[2:])
        with torch.no_grad():
            # flax xavier_uniform on the (tub·p·p·C, D) dense kernel
            bound = math.sqrt(6.0 / (cfg.patch_dim + cfg.embed_dim))
            self.proj.weight.uniform_(-bound, bound, generator=generator)
            self.proj.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.proj.weight.permute(0, 2, 3, 4, 1).reshape(self.proj.weight.shape[0], -1)  # (D, tub·p·p·C)
        return F.linear(patchify(x, self.patch, self.tubelet), w.to(x.dtype), self.proj.bias.to(x.dtype))


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------
def random_masking(
    x: torch.Tensor, mask_ratio: float, noise: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample shuffle-keep masking with a static keep count from the
    (B, L) uniform ``noise`` (the JAX model draws it with
    ``jax.random.uniform``). Returns (x_kept (B, L_keep, D), mask (B, L) in
    x's dtype with 1 = removed, ids_restore (B, L))."""
    b, l, d = x.shape
    len_keep = int(l * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_kept = torch.gather(x, 1, ids_keep[:, :, None].expand(b, len_keep, d))
    mask = torch.ones((b, l), dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    return x_kept, torch.gather(mask, 1, ids_restore), ids_restore


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class PrithviMAE(nn.Module):
    """Masked autoencoder over (B, T, H, W, C) frames.

    ``dtype`` is the compute dtype; parameters are f32 (``generator`` seeds
    flax's initializers: xavier uniform for the patch projection, lecun
    normal for the other dense layers, normal(0.02) for the cls and mask
    tokens, zero biases) and live on ``device``. With ``config.tp_axis``
    the blocks take the tensor-parallel form over ``tp_group`` (the mesh's
    'model' process group; None runs every head on this process, with no
    collectives). The same seed gives the dense and tensor-parallel models
    the same parameters. ``decoder=False`` builds the encoder alone (no
    decoder modules, no ``decoder_pos_embed``), as the segmentation backbone
    (``load_prithvi(no_decoder=True)`` in the reference, the parameters
    ``forward_encoder`` touches in flax); its state dict is the published
    layout's encoder keys. ``remat`` (off; the trainers set it from
    ``train.remat``) checkpoints each ViT block of a train-mode forward that
    records gradients. With a ``pipeline`` (``parallel.pipeline``: the
    mesh's model axis and the micro-batch count) the encoder's blocks, and
    the decoder's where the stages divide their depth, run as GPipe stages,
    this rank its own; refused beside ``tp_axis`` or ``cp_axis``.
    """

    POS_KEYS = ("pos_embed", "decoder_pos_embed")

    def __init__(
        self,
        config: PrithviConfig,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cpu",
        generator: torch.Generator | None = None,
        tp_group=None,
        decoder: bool = True,
        pipeline: Pipeline | None = None,
    ) -> None:
        super().__init__()
        cfg = self.config = config
        if cfg.dp_axis != "data":
            raise NotImplementedError(
                f"dp_axis={cfg.dp_axis!r}: the batch stays on one rank of the 'data' axis; another batch axis "
                "is not ported to s2tpu_torch yet (ROADMAP A16)"
            )
        if tp_group is not None and cfg.tp_axis is None and cfg.cp_axis is None:
            raise ValueError("a model-axis process group needs PrithviConfig(tp_axis=...) or cp_axis")
        if cfg.tp_axis is not None and cfg.cp_axis is not None and cfg.tp_axis != cfg.cp_axis:
            raise ValueError(f"tp_axis={cfg.tp_axis!r} and cp_axis={cfg.cp_axis!r}: the port has one model axis")
        for name, axis in (("tp_axis", cfg.tp_axis), ("cp_axis", cfg.cp_axis)):
            if axis not in (None, MODEL_AXIS):
                # The model's group must hold the same rows: the ranks of another axis hold other rows.
                raise ValueError(f"{name}={axis!r}: heads and tokens are split over the mesh's {MODEL_AXIS!r} axis only")
        if pipeline is not None:
            check_pipeline(cfg, pipeline)
        # GPipe over the model axis (parallel/pipeline.py): None runs every block on this rank.
        self.pipeline = pipeline
        # Context parallelism: the tokens' split between the blocks (None: every token on this rank).
        self.context = None
        if cfg.cp_axis is not None and tp_group is not None and dist.get_world_size(tp_group) > 1:
            self.context = ModelAxis(tp_group, dist.get_rank(tp_group), dist.get_world_size(tp_group))
        self.dtype = dtype
        self.remat = False
        # The trainer's data axis: the loss's denominator is the global batch's (the trainers set it).
        self.data_axis = SINGLE
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        impl, eps = cfg.attention_impl, cfg.layer_norm_eps
        tp = dict(tensor_parallel=cfg.tp_axis is not None, group=tp_group)
        self.patch_embed = PatchEmbed(cfg, gen)
        self.cls_token = nn.Parameter(0.02 * torch.randn((1, 1, cfg.embed_dim), generator=gen))
        self.blocks = nn.ModuleList(
            Block(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, impl, eps, gen, **tp) for _ in range(cfg.depth)
        )
        self.norm = LayerNorm(cfg.embed_dim, eps=eps)
        self.has_decoder = decoder
        if decoder:
            self.decoder_embed = Linear(cfg.embed_dim, cfg.decoder_embed_dim, gen)
            self.mask_token = nn.Parameter(0.02 * torch.randn((1, 1, cfg.decoder_embed_dim), generator=gen))
            self.decoder_blocks = nn.ModuleList(
                Block(cfg.decoder_embed_dim, cfg.decoder_num_heads, cfg.mlp_ratio, impl, eps, gen, **tp)
                for _ in range(cfg.decoder_depth)
            )
            self.decoder_norm = LayerNorm(cfg.decoder_embed_dim, eps=eps)
            self.decoder_pred = Linear(cfg.decoder_embed_dim, cfg.patch_dim, gen)
        for key, width in zip(self._pos_keys(), (cfg.embed_dim, cfg.decoder_embed_dim)):
            table = torch.from_numpy(sincos_3d(width, cfg.grid_size, cls_token=True))[None]
            self.register_buffer(key, table, persistent=False)
        self.to(device)

    def _pos_keys(self) -> tuple[str, ...]:
        return self.POS_KEYS if self.has_decoder else self.POS_KEYS[:1]

    def drop_position_tables(self, state_dict, prefix: str = "") -> dict:
        """``state_dict`` without the fixed position tables (under ``prefix``):
        one whose shape matches this grid must equal the table here (to
        1e-5); one of another grid is ignored."""
        state_dict = dict(state_dict)
        for key in self._pos_keys():
            incoming = state_dict.pop(prefix + key, None)
            ours = getattr(self, key)
            if incoming is not None and tuple(incoming.shape) == tuple(ours.shape):
                diff = float((torch.as_tensor(incoming).float().cpu() - ours.cpu()).abs().max())
                if diff > 1e-5:
                    raise ValueError(f"{key} is not the fixed sincos table of this grid (max |diff| {diff})")
        return state_dict

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """``nn.Module.load_state_dict`` after :meth:`drop_position_tables`."""
        return super().load_state_dict(self.drop_position_tables(state_dict), strict=strict, assign=assign)

    def encoder_pre(self, imgs: torch.Tensor, mask_ratio: float = 0.0, noise: torch.Tensor | None = None):
        """Patch embedding, position table, masking and the cls token."""
        x = self.patch_embed(imgs.to(self.dtype))
        x = x + self.pos_embed[:, 1:, :].to(x.dtype)
        b, l, _ = x.shape
        if mask_ratio > 0.0:
            if noise is None:
                raise ValueError("mask_ratio > 0 needs the (B, L) masking noise")
            x, mask, ids_restore = random_masking(x, mask_ratio, noise)
        else:
            mask = torch.zeros((b, l), dtype=x.dtype, device=x.device)
            ids_restore = torch.arange(l, device=x.device).expand(b, l)
        cls = (self.cls_token + self.pos_embed[:, :1, :]).to(x.dtype)
        x = torch.cat([cls.expand(b, 1, x.shape[-1]), x], dim=1)
        return x, mask, ids_restore

    def forward_encoder(self, imgs: torch.Tensor, mask_ratio: float = 0.0, noise: torch.Tensor | None = None):
        """(B, T, H, W, C) -> (tokens (B, 1 + L_keep, D), mask, ids_restore)."""
        x, mask, ids_restore = self.encoder_pre(imgs, mask_ratio, noise)
        x = self._run_blocks(self.blocks, x)
        return self.norm(x), mask, ids_restore

    def decoder_pre(self, tokens: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        """Decoder embedding, mask tokens put back in place, position table."""
        x = self.decoder_embed(tokens)
        b, _, d = x.shape
        l = ids_restore.shape[1]
        mask_tokens = self.mask_token.to(x.dtype).expand(b, l + 1 - x.shape[1], d)
        full = torch.cat([x[:, 1:, :], mask_tokens], dim=1)
        full = torch.gather(full, 1, ids_restore[:, :, None].expand(b, l, d))
        x = torch.cat([x[:, :1, :], full], dim=1)
        return x + self.decoder_pos_embed.to(x.dtype)

    def decoder_post(self, x: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm and pixel projection, the cls token dropped."""
        return self.decoder_pred(self.decoder_norm(x))[:, 1:, :]

    def forward_decoder(self, tokens: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        x = self.decoder_pre(tokens, ids_restore)
        x = self._run_blocks(self.decoder_blocks, x)
        return self.decoder_post(x)

    def _run_blocks(self, blocks: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
        """The blocks on (B, L, D) tokens. With a pipeline this rank runs its
        stage's blocks of a pipelined stack (:func:`pipelined_block_apply`;
        every rank gets the stack's output). Under context parallelism this
        rank runs them on its share of the padded tokens, gathered whole
        after the last block (every rank's consumers of the whole are the
        same, so the backward keeps this rank's share)."""
        remat = self.remat and self.training and torch.is_grad_enabled()
        if any(blocks is stack for stack in pipelined_stacks(self)):
            return pipelined_block_apply(blocks, x, self.pipeline, remat)
        axis, length = self.context, x.shape[1]
        if axis is not None:
            x = axis.split(_pad_tokens(x, axis.size), 1)
        for block in blocks:
            x = checkpointed(block, x, axis, length) if remat else block(x, axis, length)
        return x if axis is None else axis.gather(x, 1)[:, :length]

    def token_shard_parameters(self) -> list[nn.Parameter]:
        """The parameters whose gradients cover only this rank's tokens under
        context parallelism (:meth:`Block.token_shard_parameters`), to be
        summed over the model group after the backward; none without it."""
        if self.context is None:
            return []
        blocks = [*self.blocks, *(self.decoder_blocks if self.has_decoder else ())]
        return [p for b in blocks for p in b.token_shard_parameters()]

    def forward(self, imgs: torch.Tensor, mask_ratio: float = 0.75, noise: torch.Tensor | None = None):
        """Full MAE pass -> (loss, pred (B, L, patch_dim), mask (B, L))."""
        cfg = self.config
        latent, mask, ids_restore = self.forward_encoder(imgs, mask_ratio, noise)
        pred = self.forward_decoder(latent, ids_restore)
        target = patchify(imgs, cfg.patch_size, cfg.tubelet_size)
        loss = mae_reconstruction_loss(pred, target, mask, norm_pix=cfg.norm_pix_loss, data_axis=self.data_axis)
        return loss, pred, mask
