"""Prithvi segmentation network in PyTorch: the port of ``s2tpu/models/prithvi_seg.py``.

The Prithvi-100M encoder runs with mask ratio 0 (every token), the cls
token is dropped, and the (B, T·gh·gw, D) tokens fold into a (B, gh, gw,
T·D) grid, frames into channels frame-major. A neck of four k2 s2 transpose
convs (LayerNorm + exact GELU after the first and the third, 16x in all)
makes it dense, and an FCN head (n x [conv 3x3 - BatchNorm - ReLU], dropout,
1x1 classifier) emits the class logits.

Layout: the public input is (B, T, H, W, C) and the output (B, H', W', K)
f32 logits, as in JAX (H' = 16·gh, which is H at patch 16). Inside, the
neck and head run on NCHW-shaped ``torch.channels_last`` tensors, as the
port's UNet does.

Module names are the reference PyTorch model's state-dict names
(``backbone.*`` in the published Prithvi layout without the decoder;
``neck.feature_pyramid_net.{0,3,4,7}`` for the transpose convs and
``.{1,5}.ln`` for the LayerNorms; ``head.net.{3i}`` / ``.{3i+1}`` for the
convs and BatchNorms, ``head.net.{3n+1}`` for the classifier), so a
reference ``PrithviSegmentationNet.state_dict()`` loads with ``strict=True``.

Numerics, from the JAX model: the neck's LayerNorms take f32 statistics
with eps 1e-6 and return the compute dtype; the head's BatchNorm has flax
semantics at decay 0.9 and eps 1e-5; dropout draws its keep mask from an
explicit generator; the classifier runs in f32 on f32 input. On a data axis
of several ranks (:meth:`PrithviSegmentationNet.set_data_axis`) the head's
BatchNorm takes the global batch's statistics and dropout draws the global
batch's keep mask and keeps this rank's rows, so N ranks compute what one
process computes on the global batch. A frozen
backbone runs with no autograd graph (JAX: ``stop_gradient`` on its
output), so its attention saves nothing for a backward that never comes.
The backbone's attention takes the port's kernel route ("fused": #8/#9 up
to the fused budget, #5 beyond it), the same attention as the JAX model's
default plain route.

A backbone config with ``tp_axis`` or ``cp_axis`` runs over the model
group given as ``tp_group`` (the mesh's 'model' group): the encoder's heads,
or its tokens between the blocks, split over it, as
``PrithviMAE(tp_group=...)`` runs them; the neck and head run on the
gathered tokens on every rank. That is large-tile segmentation under
context parallelism (``tests/test_context_parallel.py``: a 512² tile is
1025 tokens).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

from s2tpu_torch.models.efficientnet_unet import BatchNorm, Conv1x1, Conv2d, ConvTranspose2d, conv_init_
from s2tpu_torch.models.prithvi_mae import LayerNorm, PrithviConfig, PrithviMAE
from s2tpu_torch.parallel.mesh import SINGLE, DataAxis

NECK_LN_EPS = 1e-6
HEAD_BN_EPS, HEAD_BN_DECAY = 1e-5, 0.9  # torch BatchNorm2d's defaults, flax's decay 0.9


@dataclass(frozen=True)
class PrithviSegmentationConfig:
    """The JAX model's config, field for field."""

    num_frames: int
    num_classes: int
    fcn_out_channels: int = 256
    fcn_num_convs: int = 1
    fcn_dropout: float = 0.1
    frozen_backbone: bool = True
    embed_dim: int = 768
    patch_height: int = 14
    patch_width: int = 14
    backbone: PrithviConfig | None = None

    @property
    def output_embed_dim(self) -> int:
        """All frames' tokens fold into channels: D·T."""
        return self.embed_dim * self.num_frames

    def backbone_config(self) -> PrithviConfig:
        if self.backbone is not None:
            return self.backbone
        return PrithviConfig(num_frames=self.num_frames, embed_dim=self.embed_dim)


class Norm2d(nn.Module):
    """LayerNorm over the channels of an NCHW-shaped tensor (the reference's
    ``Norm2d``, its parameters under ``ln``)."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.ln = LayerNorm(channels, eps=NECK_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Neck(nn.Module):
    """Token grid -> 16x upsampled dense embedding (four transpose convs)."""

    def __init__(self, channels: int) -> None:
        super().__init__()

        def up() -> ConvTranspose2d:
            return ConvTranspose2d(channels, channels, 2, stride=2)

        self.feature_pyramid_net = nn.Sequential(
            up(), Norm2d(channels), nn.GELU(), up(), up(), Norm2d(channels), nn.GELU(), up()
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.feature_pyramid_net(x)


class Dropout(nn.Module):
    """Dropout whose keep mask (uniform < 1 - rate, the draw of
    ``jax.random.bernoulli``) comes from an explicit generator on the device
    of ``x``; identity in eval mode or at rate 0. On a data axis of several
    ranks the mask is drawn for the global batch and this rank keeps its
    rows (``DataAxis.local``): the one-process draw, whatever the rank
    count."""

    data_axis: DataAxis = SINGLE

    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0] * self.data_axis.size, *x.shape[1:])
        mask = self.data_axis.local(torch.rand(shape, generator=generator, device=x.device) < keep)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class FCNHead(nn.Module):
    """n x [conv 3x3 SAME - BatchNorm - ReLU], dropout, f32 1x1 classifier."""

    def __init__(self, in_channels: int, num_classes: int, channels: int, num_convs: int, dropout: float) -> None:
        super().__init__()
        layers: list[nn.Module] = []
        for i in range(num_convs):
            cin = in_channels if i == 0 else channels
            # the ReLU runs inside the BatchNorm; an Identity keeps its index
            bn = BatchNorm(channels, HEAD_BN_EPS, HEAD_BN_DECAY, act="relu")
            layers += [Conv2d(cin, channels, 3, padding=1), bn, nn.Identity()]
        cin = channels if num_convs else in_channels
        layers += [Dropout(dropout), Conv1x1(cin, num_classes, bias=True)]
        self.net = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        *body, dropout, classifier = self.net
        for layer in body:
            x = layer(x)
        return classifier(dropout(x, generator).to(torch.float32))


class PrithviSegmentationNet(nn.Module):
    """(B, T, H, W, C) frames -> (B, 16·gh, 16·gw, K) f32 logits.

    ``dtype`` is the compute dtype. The backbone's parameters are f32 (its
    layers cast them where used); the neck's and head's conv weights are
    held in ``param_dtype`` (default: ``dtype``; the trainer asks for f32)
    and cast to ``dtype`` where used; LayerNorm, BatchNorm and the
    classifier stay f32. ``generator`` seeds flax's initialisers (the
    backbone's, and truncated-normal fan-out variance scaling for the
    convs), on the CPU, before the move to ``device``. The module starts in
    eval mode; in train mode ``forward`` takes the dropout generator.
    ``tp_group``: the model group of a backbone config with ``tp_axis`` or
    ``cp_axis``.
    """

    def __init__(
        self,
        config: PrithviSegmentationConfig,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cpu",
        generator: torch.Generator | None = None,
        param_dtype: torch.dtype | None = None,
        tp_group=None,
    ) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.backbone = PrithviMAE(config.backbone_config(), dtype=dtype, generator=gen, tp_group=tp_group,
                                   decoder=False)
        self.neck = Neck(config.output_embed_dim)
        self.head = FCNHead(
            config.output_embed_dim, config.num_classes, config.fcn_out_channels, config.fcn_num_convs,
            config.fcn_dropout,
        )
        classifier = self.head.net[-1]
        for m in [*self.neck.modules(), *self.head.modules()]:
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                conv_init_(m, gen)
                if m is not classifier:
                    m.to(param_dtype or dtype)
        self.set_frozen(config.frozen_backbone)
        self.backbone.to(device)  # its Conv3d patch weight has no 2-D channels-last form
        self.neck.to(device=device, memory_format=torch.channels_last)
        self.head.to(device=device, memory_format=torch.channels_last)
        self.eval()

    @property
    def frozen_backbone(self) -> bool:
        return self.config.frozen_backbone

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """``nn.Module.load_state_dict`` after taking out the backbone's fixed
        position table (``backbone.pos_embed``, checked against this grid's
        when the shapes match, as ``PrithviMAE.load_state_dict`` does)."""
        state_dict = self.backbone.drop_position_tables(state_dict, prefix="backbone.")
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def set_data_axis(self, data: DataAxis) -> None:
        """Run as one rank of ``data``: the head's BatchNorm statistics and
        dropout masks over the global batch (:data:`SINGLE`: this process's
        batch)."""
        for m in self.head.modules():
            if isinstance(m, (BatchNorm, Dropout)):
                m.data_axis = data

    def set_frozen(self, frozen: bool) -> None:
        """Freeze (no autograd graph through the encoder, no gradients for
        its parameters) or unfreeze the backbone."""
        self.config = dataclasses.replace(self.config, frozen_backbone=frozen)
        self.backbone.requires_grad_(not frozen)

    def tokens_to_grid(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, 1 + T·gh·gw, D) encoder tokens -> (B, T·D, gh, gw) channels-last,
        the cls token dropped and frames folded into channels frame-major."""
        cfg = self.config
        b, _, d = tokens.shape
        grid = tokens[:, 1:, :].reshape(b, cfg.num_frames, cfg.patch_height, cfg.patch_width, d)
        grid = grid.permute(0, 2, 3, 1, 4).reshape(b, cfg.patch_height, cfg.patch_width, cfg.num_frames * d)
        return grid.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, H', W', K) f32 logits; ``generator`` draws
        the train-mode dropout mask (on the device of ``x``)."""
        if self.frozen_backbone:
            with torch.no_grad():
                tokens = self.backbone.forward_encoder(x)[0]
        else:
            tokens = self.backbone.forward_encoder(x)[0]
        dense = self.neck(self.tokens_to_grid(tokens))
        return self.head(dense, generator).permute(0, 2, 3, 1)
