"""s2tpu_torch EfficientNet-UNet vs the Flax model, with weights carried across.

The JAX B0 UNet is initialised once per module, its BatchNorm statistics are
replaced with random values (positive variances), and the converted weights
are loaded into the port with ``strict=True``. Eval logits are compared in
f32 on the CPU for both of the JAX model's input stages (space-to-depth
packed, its default, and dense).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.checkpoint.convert_torch import export_reference_unet_state_dict
from s2tpu.models.efficientnet_unet import EfficientNetUNet as JaxUNet
from s2tpu.models.efficientnet_unet import EfficientNetUNetConfig as JaxConfig
from s2tpu_torch.checkpoint.convert import unet_state_dict_from_jax
from s2tpu_torch.models import efficientnet_unet as tu

DIST = (0.1, 0.2, 0.3, 0.4)


def _randomize_stats(stats, rng: np.random.Generator):
    def leaf(path, v):
        v = np.asarray(v)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
        return (0.1 * rng.normal(size=v.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(stats))


@pytest.fixture(scope="module")
def jax_b0():
    cfg = JaxConfig(version="b0", in_channels=6, num_classes=4, class_distribution=DIST)
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 6)).astype(np.float32)
    variables = jax.jit(lambda: JaxUNet(cfg).init(jax.random.key(0), jnp.zeros((1, 64, 64, 6)), train=False))()
    params = jax.device_get(variables["params"])
    stats = _randomize_stats(variables["batch_stats"], np.random.default_rng(1))
    return cfg, params, stats, x


def _port_model(params, stats) -> tu.EfficientNetUNet:
    model = tu.EfficientNetUNet(
        tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=4, class_distribution=DIST)
    )
    model.load_state_dict(unet_state_dict_from_jax(params, stats), strict=True)
    return model


@pytest.mark.parametrize("packed_input_stage", [True, False])
def test_logits_match_flax(jax_b0, packed_input_stage):
    cfg, params, stats, x = jax_b0
    jcfg = JaxConfig(**{**cfg.__dict__, "packed_input_stage": packed_input_stage})
    apply = jax.jit(lambda v, x: JaxUNet(jcfg).apply(v, x, train=False))
    ref = np.asarray(apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.inference_mode():
        ours = _port_model(params, stats)(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, 64, 64, 4)
    assert np.abs(ref).max() > 0.1  # O(1) logits, not a degenerate comparison
    assert np.abs(ours - ref).max() <= 1e-3
    assert (ours.argmax(-1) == ref.argmax(-1)).mean() >= 0.999


def test_converter_equals_jax_export(jax_b0):
    _, params, stats, _ = jax_b0
    ours = unet_state_dict_from_jax(params, stats)
    theirs = export_reference_unet_state_dict(params, stats)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        a, b = ours[key].numpy(), np.asarray(value)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_port_state_dict_names_are_the_converted_names(jax_b0):
    _, params, stats, _ = jax_b0
    model = tu.EfficientNetUNet(tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=4))
    assert set(model.state_dict()) == set(unet_state_dict_from_jax(params, stats))


@pytest.mark.parametrize("version,n_blocks,n_stride1", [("b0", 16, 12), ("b5", 39, 35)])
def test_block_specs_and_stride1_depthwise_count(version, n_blocks, n_stride1):
    cfg = tu.EfficientNetUNetConfig(version=version, in_channels=6, num_classes=4)
    jcfg = JaxConfig(version=version, in_channels=6, num_classes=4)
    from s2tpu.models.efficientnet_unet import EfficientNetEncoder

    assert [s.__dict__ for s in cfg.block_specs] == [s.__dict__ for s in EfficientNetEncoder(jcfg).block_specs]
    assert len(cfg.block_specs) == n_blocks
    assert tu.count_stride1_depthwise(cfg) == n_stride1


def test_bf16_model_keeps_batchnorm_and_classifier_f32():
    model = tu.EfficientNetUNet(tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=4), dtype=torch.bfloat16)
    assert model.encoder.stem[0].weight.dtype == torch.bfloat16
    assert model.encoder.stem[1].running_var.dtype == torch.float32
    assert model.out_conv1x1.weight.dtype == torch.float32
    with torch.inference_mode():
        y = model(torch.zeros(1, 32, 32, 6))
    assert y.dtype == torch.float32 and y.shape == (1, 32, 32, 4)
