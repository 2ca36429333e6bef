"""EfficientNet-UNet (B0-B7) in PyTorch: the port of ``s2tpu/models/efficientnet_unet.py``.

The same compound-scaled MBConv encoder (divisor-8 filter rounding, SE ratio
0.25 of the block's *input* width), a U-Net decoder with k2 s2 transpose
convs over four skip stages plus an input-concat stage, and an f32 1x1
classifier with a class-prior bias.

Layout: the public input and output are NHWC, as in JAX: (B, H, W, C) in,
(B, H, W, K) logits out. Inside, tensors are NCHW-shaped in
``torch.channels_last`` memory, so the depthwise kernel reads plain NHWC
memory and cuDNN runs its convolutions channels-last. Only the dense math
of the JAX model is ported: its space-to-depth ``packed_*`` options are TPU
layouts over the same parameters.

Module names are the reference PyTorch model's state-dict names
(``encoder.stem.0``, ``encoder.blocks.{i}.stem.*``,
``...squeeze_excitation.{1,3}``, ``...final_layer.*``, ``encoder.conv_head.*``,
``up_convs.{i}``, ``double_convs.{i}.{0,1,3,4}``, ``input_up_conv``,
``input_double_conv.*``, ``out_conv1x1``), so a reference state dict without
its unused ``encoder.fc.*`` loads with ``strict=True``. Each SiLU or ReLU that
follows a BatchNorm runs inside it (``BatchNorm.act``); a parameterless
``nn.Identity`` holds its index.

Numerics that differ from torch's defaults, taken from the JAX model:
XLA SAME padding (asymmetric at stride 2), encoder BatchNorm eps 1e-3 and
decoder eps 1e-5. In eval mode BatchNorm runs from its running statistics;
in train mode it has flax semantics (f32 statistics as E[x^2] - E[x]^2
clipped at 0, running statistics updated with the biased batch variance at
the flax decay: encoder 0.99, decoder 0.9; on the card a train-mode
BatchNorm and its activation run as one op with hand-written kernels,
``ops.batchnorm_act``), and residual MBConv blocks apply
per-sample drop-connect at ``drop_connect_rate * i / n``. Weights are cast to
the compute dtype where they are used, as flax does, so they may be stored
in f32 (training), bf16 (training with an f32 master) or in the compute
dtype (serving). With ``remat`` set, a train-mode forward that records
gradients runs each MBConv block and each decoder stage under
``models.remat.checkpointed``: the drop-connect masks are drawn before the
block, and BatchNorm leaves its running statistics alone in the recompute.

On a data axis of several ranks (:meth:`EfficientNetUNet.set_data_axis`),
each rank runs its slice of the global batch and the model computes what
the one-process model computes on the whole batch: train-mode BatchNorm
sums each channel's f32 Σx and Σx² over the ranks (the gradient flows back
through the sum) and divides by the global count, and each rank draws the
global batch's drop-connect mask and keeps its rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from s2tpu_torch.models.remat import checkpointed, recomputing
from s2tpu_torch.ops.batchnorm_act import activation, batchnorm_act
from s2tpu_torch.ops.depthwise_conv import depthwise_conv2d, same_padding
from s2tpu_torch.parallel.mesh import SINGLE, DataAxis

# (width_coefficient, depth_coefficient, resolution, dropout_rate) per version.
SCALING: dict[str, tuple[float, float, int, float]] = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

# Canonical EfficientNet stage definitions (kernel, repeats, in, out, expand,
# stride, se_ratio).
STAGES: list[tuple[int, int, int, int, int, int, float]] = [
    (3, 1, 32, 16, 1, 1, 0.25),
    (3, 2, 16, 24, 6, 2, 0.25),
    (5, 2, 24, 40, 6, 2, 0.25),
    (3, 3, 40, 80, 6, 2, 0.25),
    (5, 3, 80, 112, 6, 1, 0.25),
    (5, 4, 112, 192, 6, 2, 0.25),
    (3, 1, 192, 320, 6, 1, 0.25),
]

DECODER_BN_EPS = 1e-5  # flax BatchNorm's default: the JAX DoubleConv passes none
UP_FEATURES = (512, 256, 128, 64)


def round_filters(filters: int, width: float | None, divisor: int = 8, min_depth: int | None = None) -> int:
    """Width-scale a filter count, rounding to the divisor (never down >10%)."""
    if width is None:
        return filters
    filters *= width
    min_depth = min_depth or divisor
    new = max(min_depth, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float | None) -> int:
    return int(math.ceil(depth * repeats)) if depth is not None else repeats


@dataclass(frozen=True)
class BlockSpec:
    kernel_size: int
    in_filters: int
    out_filters: int
    expand_ratio: int
    stride: int
    se_ratio: float
    skip: bool = True


def build_block_specs(width: float, depth: float, divisor: int = 8, min_depth: int | None = None) -> list[BlockSpec]:
    specs: list[BlockSpec] = []
    for k, r, i, o, e, s, se in STAGES:
        i, o = round_filters(i, width, divisor, min_depth), round_filters(o, width, divisor, min_depth)
        r = round_repeats(r, depth)
        specs.append(BlockSpec(k, i, o, e, s, se))
        specs.extend(BlockSpec(k, o, o, e, 1, se) for _ in range(r - 1))
    return specs


@dataclass(frozen=True)
class EfficientNetUNetConfig:
    """The JAX model's config without its ``packed_*`` fields, which choose
    TPU space-to-depth layouts over the same math: the port runs the dense
    math only. The BatchNorm momenta and drop-connect serve training."""

    version: str
    in_channels: int
    num_classes: int
    bn_momentum: float = 0.99
    bn_epsilon: float = 1e-3
    depth_divisor: int = 8
    drop_connect_rate: float | None = 0.2
    min_depth: int | None = None
    class_distribution: tuple[float, ...] | None = None
    dropout_rate: float | None = None
    width_coefficient: float | None = None
    depth_coefficient: float | None = None
    concat_input: bool = True
    decoder_bn_momentum: float = 0.9
    # When set, every BatchNorm (encoder and decoder) uses this EMA decay.
    bn_momentum_override: float | None = None

    def __post_init__(self) -> None:
        if self.version not in SCALING:
            raise ValueError(f"No EfficientNet version {self.version!r}")
        if self.class_distribution is not None and not isinstance(self.class_distribution, tuple):
            object.__setattr__(self, "class_distribution", tuple(self.class_distribution))

    @property
    def scaling(self) -> tuple[float, float, float]:
        w, d, _, drop = SCALING[self.version]
        return (
            self.width_coefficient or w,
            self.depth_coefficient or d,
            self.dropout_rate or drop,
        )

    @property
    def block_specs(self) -> list[BlockSpec]:
        w, d, _ = self.scaling
        return build_block_specs(w, d, self.depth_divisor, self.min_depth)

    @property
    def enc_bn_momentum(self) -> float:
        """Encoder BatchNorm EMA decay (flax ``momentum``; torch's is 1 - it)."""
        return self.bn_momentum if self.bn_momentum_override is None else self.bn_momentum_override

    @property
    def dec_bn_momentum(self) -> float:
        """Decoder BatchNorm EMA decay (flax ``momentum``; torch's is 1 - it)."""
        return self.decoder_bn_momentum if self.bn_momentum_override is None else self.bn_momentum_override


# ---------------------------------------------------------------------------
# Layers (each subclasses the torch module whose parameters it holds, so the
# state-dict names and shapes are the reference's). Each casts its weights
# to the dtype of its input, the compute dtype, as flax casts to ``dtype``.
# ---------------------------------------------------------------------------
def _as(p: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    return None if p is None else p.to(x.dtype)


class Conv2d(nn.Conv2d):
    """Stride-1 conv with symmetric padding (the decoder's 3x3 SAME convs)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, _as(self.weight, x), _as(self.bias, x), self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """The decoder's k2 s2 transpose conv."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, _as(self.weight, x), _as(self.bias, x), self.stride)


class Conv2dSame(nn.Conv2d):
    """Conv with XLA's SAME padding, which is asymmetric at stride 2 on even
    sizes (the k3 s2 stem pads (0, 1); torch's ``padding=1`` would pad (1, 1))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ph = same_padding(x.shape[2], kh, sh)
        pw = same_padding(x.shape[3], kw, sw)
        return F.conv2d(F.pad(x, (*pw, *ph)), _as(self.weight, x), _as(self.bias, x), self.stride)


class Conv1x1(nn.Conv2d):
    """1x1 conv as a channel dot over the NHWC memory of a channels-last tensor
    (the JAX model's ``nn.Dense`` over the last axis)."""

    def __init__(self, cin: int, cout: int, bias: bool, **factory) -> None:
        super().__init__(cin, cout, 1, bias=bias, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.permute(0, 2, 3, 1), _as(self.weight.flatten(1), x), _as(self.bias, x))
        return y.permute(0, 3, 1, 2)


class DepthwiseConv(nn.Conv2d):
    """Depthwise conv (weight (C, 1, k, k)) through ``ops.depthwise_conv``:
    stride 1 runs the CUDA kernels on the card, forward and backward."""

    def __init__(self, channels: int, kernel_size: int, stride: int, **factory) -> None:
        super().__init__(channels, channels, kernel_size, stride=stride, groups=channels, bias=False, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _as(self.weight[:, 0].permute(1, 2, 0), x).contiguous()  # (k, k, C)
        y = depthwise_conv2d(x.permute(0, 2, 3, 1).contiguous(), w, self.stride[0])
        return y.permute(0, 3, 1, 2)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with the JAX model's semantics, and the activation that
    follows it (``act``: "none", "silu" or "relu"); ``decay`` is flax's
    momentum (torch's ``momentum`` is 1 - decay).

    Eval: from running statistics, scale and shift folded in f32, then
    applied in the activation dtype, then the activation. Train (flax
    ``nn.BatchNorm``, through ``ops.batchnorm_act``: the CUDA kernels on
    the card, the plain autograd form on the CPU): batch statistics in f32
    as E[x^2] - E[x]^2 clipped at 0, normalization in f32 cast back to the
    activation dtype, the activation on that, and running statistics
    updated as ``decay * running + (1 - decay) * batch`` with the biased
    variance, except in a checkpointed block's recompute, which must not
    update them a second time (the recompute sums over the data axis
    again). On a data axis of several ranks the statistics are the global
    batch's: Σx and Σx² summed over the ranks, over the global count.
    """

    data_axis: DataAxis = SINGLE

    def __init__(self, num_features: int, eps: float, decay: float, act: str = "none") -> None:
        super().__init__(num_features, eps=eps, momentum=1.0 - decay)
        self.decay = decay
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return batchnorm_act(x, self.weight, self.bias, self.running_mean, self.running_var,
                                 self.num_batches_tracked, self.eps, self.decay, self.act, self.data_axis,
                                 update=not recomputing())
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return activation(x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None], self.act)


@torch.no_grad()
def conv_init_(m: nn.Conv2d | nn.ConvTranspose2d, generator: torch.Generator) -> None:
    """flax ``variance_scaling(2.0, "fan_out", "truncated_normal")`` on a conv
    or transpose-conv weight (fan_out = kh * kw * out_features in either
    torch layout), zero bias."""
    std = math.sqrt(2.0 / (m.out_channels * m.kernel_size[0] * m.kernel_size[1])) / 0.87962566103423978
    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
    if m.bias is not None:
        nn.init.zeros_(m.bias)


def drop_connect_mask(batch: int, keep: float, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """Per-sample keep mask (B, 1, 1, 1) bool: uniform < keep, the draw of
    ``jax.random.bernoulli`` in the JAX model, from an explicit generator."""
    return torch.rand((batch, 1, 1, 1), generator=generator, device=device) < keep


class GlobalAvgPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=True)


class MBConv(nn.Module):
    """Mobile inverted bottleneck: expand -> depthwise -> SE -> project, with
    per-sample drop-connect on the residual branch in train mode."""

    data_axis: DataAxis = SINGLE

    def __init__(self, spec: BlockSpec, bn_eps: float, bn_decay: float, drop_rate: float, **factory) -> None:
        super().__init__()
        s = spec
        mid = s.in_filters * s.expand_ratio
        bn = lambda n, act="none": BatchNorm(n, eps=bn_eps, decay=bn_decay, act=act)  # noqa: E731
        layers: list[nn.Module] = []
        # each SiLU runs inside the BatchNorm before it; an Identity keeps its index
        if s.expand_ratio != 1:
            layers += [Conv1x1(s.in_filters, mid, bias=False, **factory), bn(mid, "silu"), nn.Identity()]
        layers += [DepthwiseConv(mid, s.kernel_size, s.stride, **factory), bn(mid, "silu"), nn.Identity()]
        self.stem = nn.Sequential(*layers)
        self.squeeze_excitation = None
        if 0 < s.se_ratio <= 1:
            squeezed = max(1, int(s.in_filters * s.se_ratio))
            self.squeeze_excitation = nn.Sequential(
                GlobalAvgPool(),
                Conv1x1(mid, squeezed, bias=True, **factory),
                nn.SiLU(),
                Conv1x1(squeezed, mid, bias=True, **factory),
                nn.Sigmoid(),
            )
        self.final_layer = nn.Sequential(Conv1x1(mid, s.out_filters, bias=False, **factory), bn(s.out_filters))
        self.residual = s.skip and s.stride == 1 and s.in_filters == s.out_filters
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.body(x, self.drop_mask(x, generator))

    def drop_mask(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor | None:
        """This block's train-mode drop-connect keep mask for input ``x``
        (None where the block drops nothing)."""
        if not (self.residual and self.training and self.drop_rate > 0.0):
            return None
        if generator is None:
            raise ValueError("train-mode drop-connect draws from an explicit torch.Generator: pass generator=")
        # the global batch's mask, this rank's rows of it
        mask = drop_connect_mask(x.shape[0] * self.data_axis.size, 1.0 - self.drop_rate, generator, x.device)
        return self.data_axis.local(mask)

    def body(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """The block with its drop-connect mask given."""
        y = self.stem(x)
        if self.squeeze_excitation is not None:
            y = y * self.squeeze_excitation(y)
        y = self.final_layer(y)
        if not self.residual:
            return y
        if mask is not None:
            y = y / (1.0 - self.drop_rate) * mask.to(y.dtype)
        return y + x


class EfficientNetEncoder(nn.Module):
    """Compound-scaled MBConv encoder returning the decoder's feature pyramid."""

    def __init__(self, config: EfficientNetUNetConfig, **factory) -> None:
        super().__init__()
        w, _, _ = config.scaling
        eps, decay = config.bn_epsilon, config.enc_bn_momentum
        self.specs = config.block_specs
        stem_filters = round_filters(32, w, config.depth_divisor, config.min_depth)
        self.head_filters = round_filters(1280, w, config.depth_divisor, config.min_depth)
        self.stem = nn.Sequential(
            Conv2dSame(config.in_channels, stem_filters, 3, stride=2, bias=False, **factory),
            BatchNorm(stem_filters, eps=eps, decay=decay, act="silu"),
            nn.Identity(),
        )
        n, rate = len(self.specs), config.drop_connect_rate or 0.0
        self.blocks = nn.ModuleList(MBConv(s, eps, decay, rate * i / n, **factory) for i, s in enumerate(self.specs))
        self.conv_head = nn.Sequential(
            Conv1x1(self.specs[-1].out_filters, self.head_filters, bias=False, **factory),
            BatchNorm(self.head_filters, eps=eps, decay=decay, act="silu"),
            nn.Identity(),
        )

    @property
    def skip_filters(self) -> list[int]:
        """Channel widths of the skips (1/16 first), as in the JAX encoder."""
        out: list[int] = []
        reduction = 2
        for i, s in enumerate(self.specs):
            if s.stride == 2:
                reduction *= 2
            if (s.stride == 2 or i == 0) and reduction < 32:
                out.append(s.out_filters)
        return list(reversed(out))

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None, remat: bool = False
    ) -> list[torch.Tensor]:
        """-> [1/32 conv_head, 1/16, 1/8, 1/4, 1/2]: deepest first; ``remat``
        checkpoints each block."""
        x = self.stem(x)
        skips: list[torch.Tensor] = []
        reduction = 2
        for i, (block, spec) in enumerate(zip(self.blocks, self.specs)):
            if spec.stride == 2:
                reduction *= 2
            x = checkpointed(block.body, x, block.drop_mask(x, generator)) if remat else block(x, generator)
            # first block output at each resolution above 1/32
            if (i == 0 or spec.stride == 2) and reduction < 32:
                skips.insert(0, x)
        return [self.conv_head(x), *skips]


def _double_conv(cin: int, features: int, decay: float, **factory) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(cin, features, 3, padding=1, **factory),
        BatchNorm(features, eps=DECODER_BN_EPS, decay=decay, act="relu"),
        nn.Identity(),  # the ReLU runs inside the BatchNorm
        Conv2d(features, features, 3, padding=1, **factory),
        BatchNorm(features, eps=DECODER_BN_EPS, decay=decay, act="relu"),
        nn.Identity(),
    )


def _decoder_stage(y: torch.Tensor, skip: torch.Tensor, up: nn.Module, double_conv: nn.Module) -> torch.Tensor:
    return double_conv(torch.cat([up(y), skip], dim=1))


class EfficientNetUNet(nn.Module):
    """U-Net over the EfficientNet encoder: (B, H, W, C) -> (B, H, W, K) f32 logits.

    ``dtype`` is the compute dtype. Conv and dense weights are held in
    ``param_dtype`` (default: ``dtype``, which serving uses; training keeps
    them in f32) and cast to ``dtype`` where they are used; BatchNorm
    parameters, running statistics and the classifier stay f32. Parameters
    are initialised on the CPU from ``generator`` (the JAX model's
    initialisers: truncated-normal fan-out variance scaling, class-prior
    classifier bias), then moved to ``device``. The module starts in eval
    mode; in train mode ``forward`` takes the drop-connect generator.
    ``remat`` (off; the trainer sets it from ``train.remat``) checkpoints
    each MBConv block and decoder stage of a forward that records gradients.
    """

    def __init__(
        self,
        config: EfficientNetUNetConfig,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cpu",
        generator: torch.Generator | None = None,
        param_dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = False
        self.encoder = EfficientNetEncoder(config)
        decay = config.dec_bn_momentum
        cin = self.encoder.head_filters
        self.up_convs = nn.ModuleList()
        self.double_convs = nn.ModuleList()
        for feats, skip in zip(UP_FEATURES, self.encoder.skip_filters):
            self.up_convs.append(ConvTranspose2d(cin, feats, 2, stride=2))
            self.double_convs.append(_double_conv(feats + skip, feats, decay))
            cin = feats
        self.input_up_conv = self.input_double_conv = None
        if config.concat_input:
            self.input_up_conv = ConvTranspose2d(cin, 32, 2, stride=2)
            self.input_double_conv = _double_conv(32 + config.in_channels, 32, decay)
            cin = 32
        self.out_conv1x1 = Conv1x1(cin, config.num_classes, bias=True)
        self._init_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and m is not self.out_conv1x1:
                m.to(param_dtype or dtype)
        self.to(device=device, memory_format=torch.channels_last)
        self.eval()

    def set_data_axis(self, data: DataAxis) -> None:
        """Run as one rank of ``data``: BatchNorm statistics and drop-connect
        masks over the global batch (:data:`SINGLE`: this process's batch)."""
        for m in self.modules():
            if isinstance(m, (BatchNorm, MBConv)):
                m.data_axis = data

    @torch.no_grad()
    def _init_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                conv_init_(m, generator)
        dist = self.config.class_distribution
        if dist is not None:
            d = torch.tensor(dist, dtype=torch.float32) + 1e-6
            bias = self.out_conv1x1.bias
            bias.copy_(torch.log(d[1] / d[0]).expand_as(bias) if d.shape[0] == 2 else torch.log(d))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, K) f32 logits; ``generator`` draws the
        train-mode drop-connect masks (on the device of ``x``)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        remat = self.remat and self.training and torch.is_grad_enabled()
        features = self.encoder(x, generator, remat)
        y = features[0]
        stages = list(zip(self.up_convs, self.double_convs, features[1:]))
        if self.input_up_conv is not None:
            # the input stage concatenates the normalized input itself
            stages.append((self.input_up_conv, self.input_double_conv, x))
        for up, double_conv, skip in stages:
            args = (y, skip, up, double_conv)
            y = checkpointed(_decoder_stage, *args) if remat else _decoder_stage(*args)
        logits = self.out_conv1x1(y.to(torch.float32))  # classifier in f32
        return logits.permute(0, 2, 3, 1)


def count_stride1_depthwise(config: EfficientNetUNetConfig) -> int:
    """Stride-1 depthwise layers per forward: the kernel's launches (35 for B5)."""
    return sum(s.stride == 1 for s in config.block_specs)

