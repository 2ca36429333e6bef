"""Plain float32 Prithvi MAE: the benchmark's reference for Prithvi-100M.

Follows the published model (ibm-nasa-geospatial/Prithvi-100M, its
``Prithvi.py`` and ``Prithvi_100M_config.yaml``): a ViT masked autoencoder
over (B, T, H, W, C) frames with tubelet patch embedding, fixed 3D sin-cos
position tables (6/6/4 sixteenths of the width for w/h/t, a zero row for
the cls token), per-sample random masking by the argsort of uniform noise
with a fixed keep count, pre-norm blocks (LayerNorm, multi-head attention,
LayerNorm, MLP with exact GELU) in the encoder and the decoder, and the mean
squared error of the masked patches. Attention is written out: softmax of
q k^T / sqrt(Dh), times v.

Parameter names are the published checkpoint's, so one state dict loads
into this module and into the system under test.

Departures from the published description, each one the system's and
followed here so that the two compute the same function:
- LayerNorm takes its variance as E[x^2] - E[x]^2, clipped at 0 (eps 1e-5).
- The masking noise (B, L) comes from the step's generator, after the two
  (2, B) flip draws where the step flips.
- The patch embedding is the Conv3d weight applied as patchify plus one
  dense product (stride equals kernel: the same function).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import F32, Precision


def sincos_1d(dim: int, positions: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    angles = np.outer(positions.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(angles), np.cos(angles)], axis=1)


def sincos_3d(dim: int, grid: tuple[int, int, int]) -> np.ndarray:
    """(1 + t·h·w, dim): a zero cls row, then tokens in (t, h, w) order."""
    t, h, w = grid
    dw = dh = dim // 16 * 6
    dt = dim // 16 * 4
    emb_w = np.tile(sincos_1d(dw, np.arange(w)), (t * h, 1))
    emb_h = np.tile(np.repeat(sincos_1d(dh, np.arange(h)), w, axis=0), (t, 1))
    emb_t = np.repeat(sincos_1d(dt, np.arange(t)), h * w, axis=0)
    pos = np.concatenate([emb_w, emb_h, emb_t], axis=1)
    return np.concatenate([np.zeros((1, dim)), pos], axis=0).astype(np.float32)


def patchify(x: torch.Tensor, p: int, tub: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, L, tub·p·p·C), tokens in (t, h, w) order, features (tub, p, q, c)."""
    b, t, h, w, c = x.shape
    x = x.reshape(b, t // tub, tub, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, (t // tub) * (h // p) * (w // p), tub * p * p * c)


class Linear(nn.Linear):
    def __init__(self, cin: int, cout: int, prec: Precision) -> None:
        super().__init__(cin, cout)
        self.prec = prec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.prec.cast(x), self.prec.cast(self.weight), self.bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, prec: Precision) -> None:
        super().__init__()
        self.heads, self.prec = heads, prec
        self.qkv = Linear(dim, 3 * dim, prec)
        self.proj = Linear(dim, dim, prec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        q, k, v = self.qkv(x).reshape(b, l, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        c = self.prec.cast
        s = (c(q) @ c(k).transpose(-1, -2)) / math.sqrt(d // self.heads)
        out = c(s.softmax(dim=-1)) @ c(v)
        return self.proj(out.transpose(1, 2).reshape(b, l, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, prec: Precision) -> None:
        super().__init__()
        self.fc1, self.fc2 = Linear(dim, hidden, prec), Linear(hidden, dim, prec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, eps: float, prec: Precision) -> None:
        super().__init__()
        self.norm1, self.norm2 = LayerNorm(dim, eps=eps), LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads, prec)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), prec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, p: int, tub: int, prec: Precision) -> None:
        super().__init__()
        self.p, self.tub, self.prec = p, tub, prec
        self.proj = nn.Conv3d(cin, dim, (tub, p, p), stride=(tub, p, p))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.proj.weight.permute(0, 2, 3, 4, 1).reshape(self.proj.weight.shape[0], -1)
        return F.linear(self.prec.cast(patchify(x, self.p, self.tub)), self.prec.cast(w), self.proj.bias)


class PrithviMAE(nn.Module):
    """The published MAE; ``forward`` returns the masked-patch loss."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, num_frames: int = 1, tubelet_size: int = 1,
                 in_chans: int = 6, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 decoder_embed_dim: int = 512, decoder_depth: int = 8, decoder_num_heads: int = 16,
                 mlp_ratio: float = 4.0, eps: float = 1e-5, prec: Precision = F32) -> None:
        super().__init__()
        self.p, self.tub = patch_size, tubelet_size
        grid = (num_frames // tubelet_size, img_size // patch_size, img_size // patch_size)
        self.num_patches = grid[0] * grid[1] * grid[2]
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size, tubelet_size, prec)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, eps, prec) for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=eps)
        self.decoder_embed = Linear(embed_dim, decoder_embed_dim, prec)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_embed_dim))
        self.decoder_blocks = nn.ModuleList(
            Block(decoder_embed_dim, decoder_num_heads, mlp_ratio, eps, prec) for _ in range(decoder_depth))
        self.decoder_norm = LayerNorm(decoder_embed_dim, eps=eps)
        self.decoder_pred = Linear(decoder_embed_dim, tubelet_size * patch_size * patch_size * in_chans, prec)
        self.register_buffer("pos_embed", torch.from_numpy(sincos_3d(embed_dim, grid))[None], persistent=False)
        self.register_buffer("decoder_pos_embed", torch.from_numpy(sincos_3d(decoder_embed_dim, grid))[None],
                             persistent=False)

    def attention_shapes(self, batch: int, mask_ratio: float) -> list[tuple[int, int, int, int]]:
        """(B, L, H, Dh) of every attention of a forward: the encoder's on the
        kept tokens and the cls token, the decoder's on every token."""
        keep = 1 + int(self.num_patches * (1 - mask_ratio))
        enc = [(batch, keep, b.attn.heads, b.attn.qkv.in_features // b.attn.heads) for b in self.blocks]
        dec = [(batch, 1 + self.num_patches, b.attn.heads, b.attn.qkv.in_features // b.attn.heads)
               for b in self.decoder_blocks]
        return enc + dec

    def forward(self, imgs: torch.Tensor, mask_ratio: float, noise: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) normalized frames and (B, L) noise -> the loss."""
        x = self.patch_embed(imgs) + self.pos_embed[:, 1:]
        b, l, d = x.shape
        keep = int(l * (1 - mask_ratio))
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        x = torch.gather(x, 1, ids_shuffle[:, :keep, None].expand(b, keep, d))
        mask = torch.ones((b, l), device=x.device)
        mask[:, :keep] = 0
        mask = torch.gather(mask, 1, ids_restore)
        x = torch.cat([(self.cls_token + self.pos_embed[:, :1]).expand(b, 1, d), x], dim=1)
        for block in self.blocks:
            x = block(x)
        x = self.decoder_embed(self.norm(x))
        dd = x.shape[-1]
        full = torch.cat([x[:, 1:], self.mask_token.expand(b, l + 1 - x.shape[1], dd)], dim=1)
        full = torch.gather(full, 1, ids_restore[:, :, None].expand(b, l, dd))
        x = torch.cat([x[:, :1], full], dim=1) + self.decoder_pos_embed
        for block in self.decoder_blocks:
            x = block(x)
        pred = self.decoder_pred(self.decoder_norm(x))[:, 1:]
        per_patch = ((pred - patchify(imgs, self.p, self.tub)) ** 2).mean(dim=-1)
        return (per_patch * mask).sum() / mask.sum()
