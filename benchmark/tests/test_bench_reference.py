"""The plain reference agrees with s2tpu_torch's plain path (the CPU) at
tiny shapes: the UNet's train-mode step draws and forward, the MAE's loss,
the tiled blend, Adam; and the work and FLOP counts are sound."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.lib import weights
from benchmark.reference import tiled, training
from benchmark.reference.efficientnet_unet import EfficientNetUNet
from benchmark.reference.precision import F32, FP8
from benchmark.reference.prithvi_mae import PrithviMAE

torch.set_num_threads(2)


def seeded_pair(ref: torch.nn.Module, ours: torch.nn.Module, gain: float) -> None:
    state = weights.seeded_state(ref, 3, "cpu", {"gain": gain, "norm_scale": 0.5})
    ref.load_state_dict(state)
    ours.load_state_dict(state)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_unet_matches_the_port(mode):
    from s2tpu_torch.models.efficientnet_unet import EfficientNetUNet as Port, EfficientNetUNetConfig

    ref = EfficientNetUNet("b0", 6, 4)
    port = Port(EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=4))
    seeded_pair(ref, port, 2.0)
    x = torch.randn(2, 64, 64, 6, generator=torch.Generator().manual_seed(1))
    ref.train(mode == "train")
    port.train(mode == "train")
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    # train-mode BatchNorm over 2 rows of 2^2 pixels at 1/32 amplifies f32 rounding to ~1e-4 of the logits
    torch.testing.assert_close(ref(x, generator=g1), port(x, generator=g2), rtol=1e-3, atol=1e-3)
    if mode == "train":
        bn = [n for n, _ in ref.named_buffers() if n.endswith("running_var")]
        torch.testing.assert_close(dict(ref.named_buffers())[bn[-1]], dict(port.named_buffers())[bn[-1]])


def test_mae_loss_matches_the_port():
    from s2tpu_torch.models.prithvi_mae import PrithviConfig, PrithviMAE as Port

    widths = dict(img_size=32, embed_dim=32, depth=2, num_heads=2, decoder_embed_dim=16, decoder_depth=2,
                  decoder_num_heads=2)
    ref, port = PrithviMAE(**widths), Port(PrithviConfig(**widths))
    seeded_pair(ref, port, 1.0)
    x = torch.randn(3, 1, 32, 32, 6, generator=torch.Generator().manual_seed(2))
    noise = torch.rand(3, ref.num_patches, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(ref(x, 0.75, noise), port(x, 0.75, noise)[0], rtol=1e-5, atol=1e-6)


def test_tiled_blend_matches_the_port():
    from s2tpu_torch.infer.tiled import tiled_logits

    images = torch.randn(2, 80, 96, 3, generator=torch.Generator().manual_seed(6))
    w = torch.randn(3, 5, generator=torch.Generator().manual_seed(7))

    def predict(t):
        return t @ w

    ours = tiled_logits(predict, images, 32, 24, 5, 4, graph=False)
    torch.testing.assert_close(tiled.blended_logits(predict, images, 32, 24, 4), ours, rtol=1e-5, atol=1e-5)
    assert tiled.tiles_per_segment(512, 512, 224, 192) == 9


def test_flips_and_draw_seeds_match_the_port():
    from s2tpu_torch.data.augment import random_flips
    from s2tpu_torch.train.train_state import draw_seed

    assert [training.draw_seed(2**31 + 9, s, 0) for s in range(3)] == [draw_seed(2**31 + 9, s, 0) for s in range(3)]
    images = torch.randint(0, 100, (5, 8, 8, 2), dtype=torch.int16)
    labels = torch.randint(0, 4, (5, 8, 8), dtype=torch.uint8)
    a = training.flips(images, labels, torch.Generator().manual_seed(1), 0.5, 0.5)
    b = random_flips(images, labels, torch.Generator().manual_seed(1), 0.5, 0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_focal_loss_matches_the_port():
    from s2tpu_torch.train.losses import class_weights_from_distribution, make_loss_fn

    dist = [0.0, 0.5, 0.3, 0.2]
    logits = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(8))
    labels = torch.randint(0, 4, (2, 8, 8), generator=torch.Generator().manual_seed(9))
    port = make_loss_fn("focal", 4, masked_loss=True, weighted_loss=True, class_distribution=dist, focal_gamma=2.0)
    alpha = training.class_weights(dist, masked=True)
    torch.testing.assert_close(alpha, class_weights_from_distribution(dist, 4, True))
    torch.testing.assert_close(training.focal_loss(logits, labels, alpha, 2.0, 0), port(logits, labels).total)


def test_adam_matches_torch():
    model = torch.nn.Linear(4, 3)
    twin = torch.nn.Linear(4, 3)
    twin.load_state_dict(model.state_dict())
    opt = torch.optim.Adam(twin.parameters(), lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.05)
    x = torch.randn(6, 4, generator=torch.Generator().manual_seed(3))

    class Loss:
        def __call__(self, m, images, labels, g, spec):
            return (m(images) ** 2).mean()

    training.LOSSES["linear"] = Loss()
    try:
        training.follow(model, [(x, None)] * 3, [0, 1, 2], {"kind": "linear", "lr": 1e-2, "weight_decay": 0.05,
                                                           "betas": (0.9, 0.999)})
    finally:
        del training.LOSSES["linear"]
    for _ in range(3):
        opt.zero_grad()
        (twin(x) ** 2).mean().backward()
        opt.step()
    torch.testing.assert_close(model.weight, twin.weight)


def test_fp8_control_rounds_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = FP8().cast(x)
    assert 0 < float((y - x).detach().abs().max()) <= 3 / 16 and F32.cast(x) is x
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_work_and_flops_are_counted_from_shapes():
    from benchmark.work import attention, depthwise

    b5 = EfficientNetUNet("b5", 6, 4)
    assert len(b5.stride1_depthwise(224)) == 35
    call = {"batch": 32, "size": 224, "training": True, "dtype": "bfloat16", "mask_ratio": 0.75}
    assert depthwise.least_seconds_per_call(b5, call) > 0 and attention.least_seconds_per_call(b5, call) is None
    with torch.device("meta"):
        mae = PrithviMAE()
    shapes = mae.attention_shapes(64, 0.75)
    assert shapes[0] == (64, 50, 12, 64) and shapes[-1] == (64, 197, 16, 32) and len(shapes) == 20
    assert attention.least_seconds_per_call(mae, call) > 0 and depthwise.least_seconds_per_call(mae, call) is None
    forward = 8 * (24 * 197 * 512**2 + 4 * 197**2 * 512) + 12 * (24 * 50 * 768**2 + 4 * 50**2 * 768)
    assert np.isclose(forward, 19.2e9, rtol=0.05)
