"""Plain float32 EfficientNet-UNet: the benchmark's reference for B0-B7.

Follows the published EfficientNet (Tan & Le 2019: compound width / depth
scaling, MBConv blocks with squeeze-excitation at 0.25 of the block's input
width, filters rounded to multiples of 8) and the U-Net decoder of the
system this repository ports (MaxWolf-01/sentinel2-landcover-classification,
``src/modules/efficientnet_unet.py``: k2 s2 transpose convolutions over four
skip stages and a stage that concatenates the input, double 3x3 convolutions
with BatchNorm and ReLU, a 1x1 classifier). Input (B, H, W, C), output
(B, H, W, K) logits, as the system under test takes and gives them.

The parameter names are the reference model's state-dict names, so one
state dict loads into this module and into the system under test.

Departures from the published description, each one the system's and
followed here so that the two compute the same function:
- SAME padding as XLA computes it: asymmetric at stride 2 on even sizes.
- BatchNorm in training mode takes float32 statistics as E[x^2] - E[x]^2,
  clipped at 0, and updates its running statistics with the biased batch
  variance at flax's decay (encoder 0.99, decoder 0.9; eps 1e-3 / 1e-5).
- Drop-connect keeps a residual branch where a uniform draw is below
  ``1 - rate``, one (B, 1, 1, 1) draw a block from the step's generator, in
  forward order, at rate ``drop_connect_rate * i / n`` for block i of n.
- The classifier's input is float32 (the whole reference is).
Every product is float32 unless the model is given another
:class:`~benchmark.reference.precision.Precision` (the control).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import F32, Precision

# (width, depth) per version: Tan & Le 2019, Table / the reference's efficientnet_unet.py:35-46.
SCALING = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}
# (kernel, repeats, in, out, expand, stride) of EfficientNet-B0's seven stages.
STAGES = [(3, 1, 32, 16, 1, 1), (3, 2, 16, 24, 6, 2), (5, 2, 24, 40, 6, 2), (3, 3, 40, 80, 6, 2),
          (5, 3, 80, 112, 6, 1), (5, 4, 112, 192, 6, 2), (3, 1, 192, 320, 6, 1)]
SE_RATIO = 0.25
UP_FEATURES = (512, 256, 128, 64)
ENCODER_BN = (1e-3, 0.99)  # (eps, decay)
DECODER_BN = (1e-5, 0.9)


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


@dataclass(frozen=True)
class Block:
    kernel: int
    cin: int
    cout: int
    expand: int
    stride: int


def block_specs(version: str) -> list[Block]:
    width, depth = SCALING[version]
    out: list[Block] = []
    for k, r, i, o, e, s in STAGES:
        i, o = round_filters(i, width), round_filters(o, width)
        out.append(Block(k, i, o, e, s))
        out.extend(Block(k, o, o, e, 1) for _ in range(int(math.ceil(depth * r)) - 1))
    return out


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """A convolution with XLA SAME padding (1x1, 3x3, depthwise, the stem)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1, bias: bool = False,
                 prec: Precision = F32) -> None:
        super().__init__(cin, cout, k, stride=stride, groups=groups, bias=bias)
        self.prec = prec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        ph, pw = same_padding(x.shape[2], k, s), same_padding(x.shape[3], k, s)
        x = F.pad(x, (*pw, *ph))
        return F.conv2d(self.prec.cast(x), self.prec.cast(self.weight), self.bias, self.stride, 0, 1, self.groups)


class UpConv(nn.ConvTranspose2d):
    def __init__(self, cin: int, cout: int, prec: Precision = F32) -> None:
        super().__init__(cin, cout, 2, stride=2)
        self.prec = prec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(self.prec.cast(x), self.prec.cast(self.weight), self.bias, 2)


class BatchNorm(nn.BatchNorm2d):
    def __init__(self, n: int, eps: float, decay: float) -> None:
        super().__init__(n, eps=eps, momentum=1.0 - decay)
        self.decay = decay

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, ex2 = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
            var = (ex2 - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.decay).add_((1.0 - self.decay) * mean)
                self.running_var.mul_(self.decay).add_((1.0 - self.decay) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class GlobalAvgPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=True)


def squeeze_excitation(mid: int, squeezed: int, prec: Precision) -> nn.Sequential:
    return nn.Sequential(GlobalAvgPool(), Conv(mid, squeezed, 1, bias=True, prec=prec), nn.SiLU(),
                         Conv(squeezed, mid, 1, bias=True, prec=prec), nn.Sigmoid())


class MBConv(nn.Module):
    def __init__(self, b: Block, drop_rate: float, prec: Precision) -> None:
        super().__init__()
        mid = b.cin * b.expand
        eps, decay = ENCODER_BN
        layers: list[nn.Module] = []
        if b.expand != 1:
            layers += [Conv(b.cin, mid, 1, prec=prec), BatchNorm(mid, eps, decay), nn.SiLU()]
        layers += [Conv(mid, mid, b.kernel, b.stride, groups=mid, prec=prec), BatchNorm(mid, eps, decay), nn.SiLU()]
        self.stem = nn.Sequential(*layers)
        self.squeeze_excitation = squeeze_excitation(mid, max(1, int(b.cin * SE_RATIO)), prec)
        self.final_layer = nn.Sequential(Conv(mid, b.cout, 1, prec=prec), BatchNorm(b.cout, eps, decay))
        self.residual = b.stride == 1 and b.cin == b.cout
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        mask = None
        if self.residual and self.training and self.drop_rate > 0.0 and generator is not None:
            mask = torch.rand((x.shape[0], 1, 1, 1), generator=generator, device=x.device) < 1.0 - self.drop_rate
        y = self.stem(x)
        y = self.final_layer(y * self.squeeze_excitation(y))
        if not self.residual:
            return y
        if mask is not None:
            y = y / (1.0 - self.drop_rate) * mask.to(y.dtype)
        return y + x


def double_conv(cin: int, cout: int, prec: Precision) -> nn.Sequential:
    eps, decay = DECODER_BN
    return nn.Sequential(Conv(cin, cout, 3, bias=True, prec=prec), BatchNorm(cout, eps, decay), nn.ReLU(),
                         Conv(cout, cout, 3, bias=True, prec=prec), BatchNorm(cout, eps, decay), nn.ReLU())


class Encoder(nn.Module):
    def __init__(self, version: str, in_channels: int, drop_connect_rate: float, prec: Precision) -> None:
        super().__init__()
        width, _ = SCALING[version]
        self.specs = block_specs(version)
        stem, self.head_filters = round_filters(32, width), round_filters(1280, width)
        eps, decay = ENCODER_BN
        self.stem = nn.Sequential(Conv(in_channels, stem, 3, 2, prec=prec), BatchNorm(stem, eps, decay), nn.SiLU())
        n = len(self.specs)
        self.blocks = nn.ModuleList(MBConv(s, drop_connect_rate * i / n, prec) for i, s in enumerate(self.specs))
        self.conv_head = nn.Sequential(Conv(self.specs[-1].cout, self.head_filters, 1, prec=prec),
                                       BatchNorm(self.head_filters, eps, decay), nn.SiLU())

    def skip_filters(self) -> list[int]:
        out, reduction = [], 2
        for i, s in enumerate(self.specs):
            reduction *= 2 if s.stride == 2 else 1
            if (s.stride == 2 or i == 0) and reduction < 32:
                out.append(s.cout)
        return out[::-1]

    def forward(self, x: torch.Tensor, generator: torch.Generator | None) -> list[torch.Tensor]:
        x = self.stem(x)
        skips, reduction = [], 2
        for i, (block, spec) in enumerate(zip(self.blocks, self.specs)):
            reduction *= 2 if spec.stride == 2 else 1
            x = block(x, generator)
            if (i == 0 or spec.stride == 2) and reduction < 32:
                skips.insert(0, x)
        return [self.conv_head(x), *skips]


class EfficientNetUNet(nn.Module):
    """(B, H, W, C) -> (B, H, W, K) float32 logits; starts in eval mode."""

    def __init__(self, version: str, in_channels: int, num_classes: int, drop_connect_rate: float = 0.2,
                 prec: Precision = F32) -> None:
        super().__init__()
        self.encoder = Encoder(version, in_channels, drop_connect_rate, prec)
        cin = self.encoder.head_filters
        self.up_convs, self.double_convs = nn.ModuleList(), nn.ModuleList()
        for feats, skip in zip(UP_FEATURES, self.encoder.skip_filters()):
            self.up_convs.append(UpConv(cin, feats, prec))
            self.double_convs.append(double_conv(feats + skip, feats, prec))
            cin = feats
        self.input_up_conv = UpConv(cin, 32, prec)
        self.input_double_conv = double_conv(32 + in_channels, 32, prec)
        self.out_conv1x1 = Conv(32, num_classes, 1, bias=True, prec=prec)
        self.eval()

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        features = self.encoder(x, generator)
        y = features[0]
        for up, dc, skip in zip([*self.up_convs, self.input_up_conv], [*self.double_convs, self.input_double_conv],
                                [*features[1:], x]):
            y = dc(torch.cat([up(y), skip], dim=1))
        return self.out_conv1x1(y).permute(0, 2, 3, 1)

    def stride1_depthwise(self, size: int) -> list[tuple[int, int, int]]:
        """(k, C, H) of every stride-1 depthwise convolution of a forward at
        ``size``^2, in order: the work the depthwise kernels take."""
        out, h = [], -(-size // 2)
        for spec in self.encoder.specs:
            if spec.stride == 1:
                out.append((spec.kernel, spec.cin * spec.expand, h))
            else:
                h = -(-h // 2)
        return out
