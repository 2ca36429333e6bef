"""int8 post-training quantization in s2tpu_torch (``infer.quantize``) against ``s2tpu.infer.quantize``, on the CPU.

Counterparts of ``tests/test_quantize.py``. One layer (a Dense, a strided
padded 3x3 conv) given JAX's weights and input quantizes to the same int8
weights and the same int32 sums, bit for bit: both quantize in f32 with the
scale a runtime f32 value (JAX's serving program takes the qstate as an
argument; the JAX side here is jitted the same way), and integer sums are
exact. Their outputs then differ only where XLA fuses the f32 scale and the
bias (at most an ulp): LAYER_RTOL. The quantized layer sets of B0
(``packed_input_stage`` default), the tiny Prithvi MAE and the tiny
fc-prithvi equal JAX's, its paths taken from ``jax.eval_shape`` of
``collect_forward_maxabs`` (no compile). Deeper comparisons calibrate each
side on its own f32 forward, which differs from the other's by rounding
(activation scales within 2e-7); no activation rounds to the other int8
step on these inputs, so the tiny Prithvi encoder's int8 output agrees
with JAX's to INT8_ENCODER_RTOL of its scale (measured: 1.3e-7; a flipped
step would move it by ~1/127 of a layer's share), and each side's int8
encoder with its own float one to JAX's bound (0.1 relative L2,
``tests/test_quantize.py:101``; measured 0.016).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from s2tpu.infer import quantize as jq
from s2tpu.models import prithvi_mae as jm
from s2tpu.models.efficientnet_unet import EfficientNetUNet as JaxUNet
from s2tpu.models.efficientnet_unet import EfficientNetUNetConfig as JaxUNetConfig
from s2tpu.models.prithvi_seg import PrithviSegmentationConfig as JaxSegConfig
from s2tpu.models.prithvi_seg import PrithviSegmentationNet as JaxSegNet
from s2tpu_torch.checkpoint.convert import prithvi_state_dict_from_jax
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.data.dataset import make_synthetic_fixture
from s2tpu_torch.data.pipeline import Datamodule
from s2tpu_torch.infer import aot
from s2tpu_torch.infer import quantize as pq
from s2tpu_torch.infer.predict import Predictor
from s2tpu_torch.infer.tiled import tiled_predict_many
from s2tpu_torch.models import prithvi_mae as tm
from s2tpu_torch.models import prithvi_seg as ts
from s2tpu_torch.models.efficientnet_unet import Conv2dSame, EfficientNetUNet, EfficientNetUNetConfig

torch.set_num_threads(2)

LAYER_RTOL = 1e-6
INT8_ENCODER_RTOL = 1e-4
PRITHVI = dict(img_size=32, patch_size=8, num_frames=1, in_chans=6, embed_dim=64, depth=2, num_heads=4,
               decoder_embed_dim=48, decoder_depth=1, decoder_num_heads=4)


def _rel_err(q, f) -> float:
    q, f = np.asarray(q, np.float64), np.asarray(f, np.float64)
    return float(np.linalg.norm(q - f) / (np.linalg.norm(f) + 1e-12))


def _jax_int8(model, variables, qstate, *args, **kwargs):
    """JAX's quantized forward with the qstate as a runtime argument, as its
    serving program takes it (``quantize_segmentation_trainer``)."""
    return jax.jit(lambda v, q, *a: jq.quantized_apply(model, v, q, *a, **kwargs))(variables, qstate, *args)


def _port_q(qstate: dict) -> dict:
    return pq.QuantState(qstate).entry("")


def test_quantized_dense_matches_jax(rng):
    model = nn.Dense(64)
    x = rng.normal(size=(32, 48)).astype(np.float32)
    variables = jax.device_get(model.init(jax.random.key(0), x))
    j_scales = jq.calibrate_model(model, variables, [jnp.asarray(x)])
    j_q = jq.quantize_weights(variables["params"], j_scales)

    layer = tm.Linear(48, 64, torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.array(variables["params"]["kernel"]).T))
        layer.bias.copy_(torch.from_numpy(np.array(variables["params"]["bias"])))
    scales = pq.calibrate_model(layer, [torch.from_numpy(x)])
    assert scales == j_scales  # one Dense == one calibrated path, the same max-abs
    qstate = pq.quantize_weights(layer, scales)
    np.testing.assert_array_equal(qstate[""]["w_int8"].numpy(), np.asarray(j_q[""]["w_int8"]).T)

    def jax_sums(x, q):
        xq = jq._quantize_input(x, q["x_scale"])
        return jax.lax.dot_general(xq, q["w_int8"], (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)

    want_sums = np.asarray(jax.jit(jax_sums)(x, j_q[""]))
    got_sums = pq.int8_sums(layer, torch.from_numpy(x), _port_q(qstate)).numpy()
    assert got_sums.dtype == np.int32
    np.testing.assert_array_equal(got_sums, want_sums)

    qlayer, _ = pq.quantized(layer, qstate)
    with torch.no_grad():
        got = qlayer(torch.from_numpy(x)).numpy()
    want = np.asarray(_jax_int8(model, variables, j_q, x))
    np.testing.assert_allclose(got, want, rtol=0, atol=LAYER_RTOL * np.abs(want).max())
    assert _rel_err(got, model.apply(variables, x)) < 0.02


def test_quantized_conv_strided_padded_matches_jax(rng):
    model = nn.Conv(24, (3, 3), strides=(2, 2), padding="SAME")
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    variables = jax.device_get(model.init(jax.random.key(0), x))
    j_q = jq.quantize_weights(variables["params"], jq.calibrate_model(model, variables, [jnp.asarray(x)]))

    layer = Conv2dSame(8, 24, 3, stride=2, bias=True)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.array(variables["params"]["kernel"]).transpose(3, 2, 0, 1)))
        layer.bias.copy_(torch.from_numpy(np.array(variables["params"]["bias"])))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    qstate = pq.quantize_weights(layer, pq.calibrate_model(layer, [xt]))
    k = np.asarray(j_q[""]["w_int8"])  # (kh, kw, I, O)
    np.testing.assert_array_equal(qstate[""]["w_int8"].numpy(), k.transpose(3, 0, 1, 2).reshape(24, -1))

    def jax_sums(x, q):
        xq = jq._quantize_input(x, q["x_scale"])
        return jax.lax.conv_general_dilated(xq, q["w_int8"], (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                            preferred_element_type=jnp.int32)

    want_sums = np.asarray(jax.jit(jax_sums)(x, j_q[""]))
    got_sums = pq.int8_sums(layer, xt, _port_q(qstate)).numpy()
    np.testing.assert_array_equal(got_sums, want_sums)

    qlayer, _ = pq.quantized(layer, qstate)
    with torch.no_grad():
        got = qlayer(xt).permute(0, 2, 3, 1).numpy()
    want = np.asarray(_jax_int8(model, variables, j_q, x))
    assert got.shape == want.shape == (2, 8, 8, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=LAYER_RTOL * np.abs(want).max())
    assert _rel_err(got, model.apply(variables, x)) < 0.02


def _jax_paths(model, x, init_kwargs: dict, apply_kwargs: dict, method=None) -> set[str]:
    variables = jax.eval_shape(lambda: model.init(jax.random.key(0), x, **init_kwargs))
    paths = jax.eval_shape(
        lambda v: jq.collect_forward_maxabs(lambda: model.apply(v, x, **apply_kwargs, method=method)), variables
    )
    return set(paths)


def _port_paths(model: torch.nn.Module, forward, x: torch.Tensor) -> set[str]:
    rec = pq.ActivationRecorder()
    with torch.no_grad(), rec.recording(model):
        forward(x)
    return set(rec.maxabs)


def _seg_configs(patch: int = 8):
    """``tests/test_quantize.py:109-117``'s tiny fc-prithvi; at patch 16 its
    logits are the input's size (the neck upsamples the patch grid 16x)."""
    widths = {**PRITHVI, "patch_size": patch}
    seg = dict(num_frames=1, num_classes=4, frozen_backbone=False, embed_dim=64, patch_height=32 // patch,
               patch_width=32 // patch, fcn_out_channels=32)
    return (JaxSegConfig(**seg, backbone=jm.PrithviConfig(**widths)),
            ts.PrithviSegmentationConfig(**seg, backbone=tm.PrithviConfig(**widths)))


@pytest.mark.parametrize("family", ["b0", "prithvi_encoder", "prithvi_mae", "fc_prithvi"])
def test_quantized_layer_set_equals_jax(family):
    if family == "b0":
        x = jnp.zeros((1, 64, 64, 6))
        want = _jax_paths(JaxUNet(JaxUNetConfig(version="b0", in_channels=6, num_classes=4)), x, {"train": False},
                          {"train": False})
        model = EfficientNetUNet(EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=4))
        got = _port_paths(model, model, torch.zeros(1, 64, 64, 6))
        assert "input_double_conv/conv0" not in want and "double_conv3/conv0" in want  # packed_input_stage
    elif family.startswith("prithvi"):
        x = jnp.zeros((1, 1, 32, 32, 6))
        encoder = family == "prithvi_encoder"
        jmodel = jm.PrithviMAE(jm.PrithviConfig(**PRITHVI))
        kwargs = {"mask_ratio": 0.0}
        want = _jax_paths(jmodel, x, kwargs, kwargs, method=jm.PrithviMAE.forward_encoder if encoder else None)
        model = tm.PrithviMAE(tm.PrithviConfig(**PRITHVI))
        got = _port_paths(model, (lambda t: model.forward_encoder(t, 0.0)) if encoder else (lambda t: model(t, 0.0)),
                          torch.zeros(1, 1, 32, 32, 6))
        assert ("decoder_pred" in want) != encoder
    else:
        jcfg, tcfg = _seg_configs()
        x = jnp.zeros((1, 1, 32, 32, 6))
        want = _jax_paths(JaxSegNet(jcfg), x, {"train": False}, {"train": False})
        model = ts.PrithviSegmentationNet(tcfg)
        got = _port_paths(model, model, torch.zeros(1, 1, 32, 32, 6))
        assert "head/classifier" in want and not any("up" in p for p in want)  # the neck's transpose convs stay float
    assert got == want


def test_prithvi_quantized_encoder_matches_jax(rng):
    cfg = jm.PrithviConfig(**PRITHVI)
    jmodel = jm.PrithviMAE(cfg)
    x = rng.normal(size=(2, 1, 32, 32, 6)).astype(np.float32)
    params = jax.device_get(jax.jit(lambda: jmodel.init(jax.random.key(0), x, mask_ratio=0.0))()["params"])
    variables = {"params": params}
    rec = jq.ActivationRecorder()
    with rec.recording():
        jmodel.apply(variables, x, 0.0, method=jm.PrithviMAE.forward_encoder)
    j_q = jq.quantize_weights(params, rec.scales())

    model = tm.PrithviMAE(tm.PrithviConfig(**PRITHVI), decoder=False)
    from s2tpu_torch.checkpoint.convert import encoder_state_dict

    model.load_state_dict(encoder_state_dict(prithvi_state_dict_from_jax(params, cfg)), strict=True)
    xt = torch.from_numpy(x)
    qstate = pq.quantize_weights(model, pq.calibrate_model(model, [xt], lambda t: model.forward_encoder(t, 0.0)))
    assert set(qstate) == set(j_q) and any("qkv" in p for p in qstate) and any("mlp_fc1" in p for p in qstate)
    for path, q in qstate.items():
        k = np.asarray(j_q[path]["w_int8"])
        k = k.reshape(-1, k.shape[-1]).T  # (I, O) and the patch projection's (tub·p·q·C, D) -> (O, K)
        np.testing.assert_array_equal(q["w_int8"].numpy(), k, err_msg=path)
        np.testing.assert_allclose(float(q["x_scale"]), j_q[path]["x_scale"], rtol=1e-5, err_msg=path)

    want = np.asarray(_jax_int8(jmodel, variables, j_q, x, mask_ratio=0.0, method=jm.PrithviMAE.forward_encoder)[0])
    qmodel, _ = pq.quantized(model, qstate)
    with torch.no_grad():
        got = qmodel.forward_encoder(xt, 0.0)[0].numpy()
        got_float = model.forward_encoder(xt, 0.0)[0].numpy()
    assert np.abs(got - want).max() <= INT8_ENCODER_RTOL * np.abs(want).max()
    assert _rel_err(got, got_float) < 0.1
    assert _rel_err(want, jmodel.apply(variables, x, 0.0, method=jm.PrithviMAE.forward_encoder)[0]) < 0.1


def _b0_served(tmp_path):
    make_synthetic_fixture(tmp_path, aoi="small", label_map="osm-multiclass", n_segments=4, size=(96, 96))
    config = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    config.datamodule.dataset_cfg.data_dir = str(tmp_path)
    config.datamodule.batch_size = 2
    config.datamodule.data_split = (1.0, 0.0, 0.0)
    config.datamodule.random_crop_size = 64
    dm = Datamodule(config.datamodule)
    model = config.build_model(dtype=torch.float32, device="cpu")
    predictor = Predictor(model, *dm.mean_std(), torch.float32, torch.device("cpu"))
    images = np.stack([np.asarray(dm.source[0].x)])
    return config, dm, predictor, images


def test_int8_tiled_serving_agrees_with_float_on_confident_pixels(tmp_path):
    """quantize_for_serving -> tiled_predict_many, against the float path on
    the pixels whose float top-2 margin is above the median
    (``tests/test_quantize.py:138-180``)."""
    config, dm, predictor, images = _b0_served(tmp_path)
    qpredictor = pq.quantize_for_serving(predictor, dm, n_batches=1)
    assert qpredictor.model.quant.paths and predictor.model is not qpredictor.model
    cm_q, _ = tiled_predict_many(qpredictor, images, num_classes=config.num_classes, tile=64)
    cm_f, logits_f = tiled_predict_many(predictor, images, num_classes=config.num_classes, tile=64,
                                        return_logits=True)
    top2 = np.sort(logits_f[0], axis=-1)
    margin = top2[..., -1] - top2[..., -2]
    confident = margin > np.quantile(margin, 0.5)
    agree = (cm_q[0] == cm_f[0])[confident].mean()
    assert agree > 0.97, f"int8/float class maps disagree on confident pixels: {agree:.3f}"


def test_int8_weights_are_runtime_inputs(tmp_path, rng):
    """One exported int8 program serves any quantized weights of the same
    shapes: zeroed int8 weights in its inputs change its output
    (``tests/test_quantize.py:183``); the tiled path with ``aot_cache``
    equals the uncached one, cold and warm."""
    _, tcfg = _seg_configs(patch=16)
    model = ts.PrithviSegmentationNet(dataclasses.replace(tcfg, frozen_backbone=True))
    tiles = torch.from_numpy(rng.integers(0, 4000, size=(2, 32, 32, 6)).astype(np.int16))
    predictor = Predictor(model, np.full(6, 1000.0), np.full(6, 500.0), torch.float32, torch.device("cpu"),
                          squeeze_time_dim=False)
    qstate = pq.quantize_weights(model, pq.calibrate_model(model, [tiles], predictor))
    qmodel, quant = pq.quantized(model, qstate)
    qpredictor = Predictor(qmodel, predictor.mean, predictor.std, torch.float32, torch.device("cpu"),
                           squeeze_time_dim=False)
    state = {k: v.detach() for k, v in qpredictor.state().items()}
    assert any(k.endswith(":w_int8") for k in state)
    program = aot.export_program(tmp_path / "q.aot", aot._Program(qpredictor.program), state, tiles).module()
    with torch.no_grad():
        base = program(state, tiles)
        np.testing.assert_array_equal(base.numpy(), qpredictor(tiles).numpy())
        zeroed = {k: torch.zeros_like(v) if k.endswith(":w_int8") else v for k, v in state.items()}
        assert not torch.allclose(program(zeroed, tiles), base), "quantized weights were baked into the program"

    images = rng.integers(0, 4000, size=(1, 64, 64, 6)).astype(np.int16)
    kw = dict(num_classes=4, tile=32, overlap=8, batch_size=4)
    ref, _ = tiled_predict_many(qpredictor, images, **kw)
    for _ in range(2):  # export, then load in a fresh predictor of the same state
        fresh = Predictor(qmodel, predictor.mean, predictor.std, torch.float32, torch.device("cpu"),
                          squeeze_time_dim=False)
        got, _ = tiled_predict_many(fresh, images, aot_cache=str(tmp_path / "tiled.aot"), **kw)
        assert (tmp_path / "tiled.aot").exists()
        np.testing.assert_array_equal(got, ref)
    assert quant.paths
