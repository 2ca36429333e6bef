"""The serving slice as a whole: s2tpu_torch's tiled infer CLI vs s2tpu's tiled_predict_many.

One set of JAX B0 weights (random BatchNorm statistics) is carried into a
port checkpoint; the port's CLI serves the conftest fixture on the CPU and
its class maps are held against the JAX tiled program's for the same
weights, split and statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.data.augment import normalize as jax_normalize
from s2tpu.data.pipeline import Datamodule
from s2tpu.geo.tiff import read_geotiff
from s2tpu.infer.tiled import tiled_predict_many as jax_tiled_predict_many
from s2tpu.models.efficientnet_unet import EfficientNetUNet as JaxUNet
from s2tpu.models.efficientnet_unet import EfficientNetUNetConfig as JaxConfig
from s2tpu_torch.checkpoint.convert import unet_state_dict_from_jax
from s2tpu_torch.checkpoint.io import load_checkpoint, save_checkpoint
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.data import statistics
from s2tpu_torch.data.dataset import TiffSource, train_val_test_split

CROP = 64


def _configure(c, data_dir):
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = 2
    c.datamodule.data_split = (0.5, 0.5, 0.0)
    c.datamodule.random_crop_size = CROP
    c.train.compute_dtype = "float32"
    return c


@pytest.fixture(scope="module")
def served(fixture_dir, tmp_path_factory):
    """Port checkpoint from JAX weights + both packages' outputs for the val split."""
    jcfg = _configure(jax_cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass"), fixture_dir)
    model = JaxUNet(JaxConfig(version="b0", in_channels=6, num_classes=4))
    variables = jax.jit(lambda: model.init(jax.random.key(3), jnp.zeros((1, CROP, CROP, 6)), train=False))()
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (
            rng.uniform(0.5, 1.5, np.shape(v)) if path[-1].key == "var" else 0.1 * rng.normal(size=np.shape(v))
        ).astype(np.float32),
        jax.device_get(variables["batch_stats"]),
    )
    params = jax.device_get(variables["params"])

    tmp = tmp_path_factory.mktemp("torch_infer")
    pcfg = _configure(cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass"), fixture_dir)
    save_checkpoint(tmp / "ckpt", pcfg, unet_state_dict_from_jax(params, stats))

    from s2tpu_torch.cli.infer import main

    out_dir = tmp / "preds"
    main([str(tmp / "ckpt"), "--tiled", "--out", str(out_dir), "--data-dir", str(fixture_dir), "--device", "cpu"])
    logits_dir = tmp / "logits"
    main([str(tmp / "ckpt"), "--out", str(logits_dir), "--data-dir", str(fixture_dir), "--device", "cpu"])

    dm = Datamodule(jcfg.datamodule)
    mean, std = dm.mean_std()

    def predict_fn(variables, tiles):
        return model.apply(variables, jax_normalize(tiles, mean, std, dtype=jnp.float32), train=False)

    imgs, seg_ids = [], []
    for i in dm.val_idx:
        img, _ = dm.source.read_with_geo(int(i))
        imgs.append(img)
        seg_ids.append(dm.source.label_index_for(int(i)))
    jax_maps, _ = jax_tiled_predict_many(
        predict_fn, {"params": params, "batch_stats": stats}, np.stack(imgs), num_classes=4, tile=CROP
    )
    return dict(out_dir=out_dir, logits_dir=logits_dir, dm=dm, jax_maps=dict(zip(seg_ids, jax_maps)), ckpt=tmp / "ckpt")


def test_tiled_cli_class_maps_match_jax(served):
    preds = sorted(served["out_dir"].glob("pred_*.tif"))
    assert len(preds) == 3  # val split of 6 segments
    assert {int(p.stem.split("_")[1]) for p in preds} == set(served["jax_maps"])
    for p in preds:
        data, geo = read_geotiff(p)
        assert data.shape == (1, 96, 96)
        assert data.max() <= 3
        assert geo is not None  # georeferencing carried through
        ref = served["jax_maps"][int(p.stem.split("_")[1])]
        assert (data[0] == ref).mean() >= 0.999


def test_batch_logits_mode_writes_batches(served):
    batches = sorted(served["logits_dir"].glob("batch_*.npy"))
    assert len(batches) >= 1
    logits = np.load(batches[0])
    assert logits.shape == (3, CROP, CROP, 4)
    assert np.isfinite(logits).all()


def test_split_and_statistics_equal_s2tpu(served, fixture_dir):
    dm = served["dm"]
    source = TiffSource("small", "osm-multiclass", str(fixture_dir))
    ours = train_val_test_split(len(source), (0.5, 0.5, 0.0), seed=0)
    for a, b in zip(ours, (dm.train_idx, dm.val_idx, dm.test_idx)):
        np.testing.assert_array_equal(a, b)
    stats = statistics.calculate_mean_std(source)
    mean, std = dm.mean_std()
    np.testing.assert_array_equal(np.asarray(stats["mean"], np.float32), mean)
    np.testing.assert_array_equal(np.asarray(stats["std"], np.float32), std)


def test_checkpoint_roundtrip(served):
    config, state_dict = load_checkpoint(served["ckpt"])
    assert config.model_name == cfg_lib.ModelName.EFFICIENTNET_UNET_B0
    assert config.num_classes == 4 and config.datamodule.data_split == (0.5, 0.5, 0.0)
    model = config.build_model(device="cpu")
    model.load_state_dict(state_dict, strict=True)
    assert all(isinstance(v, torch.Tensor) for v in state_dict.values())


def test_config_json_from_s2tpu_parses(tmp_path):
    """A config.json as s2tpu's CheckpointManager writes it parses unchanged."""
    import json

    jc = jax_cfg_lib.base_config("efficientnet-unet-b5", aoi="small", label_map="osm-multiclass")
    text = json.dumps(jax_cfg_lib.config_to_dict(jc), default=str, indent=2)
    config = cfg_lib.config_from_dict(json.loads(text))
    assert json.loads(json.dumps(cfg_lib.config_to_dict(config), default=str)) == json.loads(text)
    assert config.model_name.value == "efficientnet-unet-b5" and config.num_classes == jc.num_classes


def test_fc_prithvi_builds_on_the_cpu_with_an_encoder_only_backbone():
    """Prithvi-100M's full widths (12 x 768, 12 heads) under the seg neck and
    head; no decoder parameters; (B, T, H, W, C) in, (B, H, W, K) out."""
    config = cfg_lib.base_config("fc-prithvi-backbone", aoi="small", label_map="osm-multiclass")
    config.datamodule.random_crop_size = 32
    model = config.build_model(dtype=torch.float32, device="cpu")
    keys = list(model.state_dict())
    assert "backbone.blocks.11.attn.qkv.weight" in keys and "backbone.pos_embed" not in keys
    assert not any(k.startswith("backbone.decoder") or k == "backbone.mask_token" for k in keys)
    assert model.backbone.blocks[0].attn.qkv.weight.shape == (3 * 768, 768)
    assert model.neck.feature_pyramid_net[0].weight.shape == (768, 768, 2, 2)
    assert all(not p.requires_grad for p in model.backbone.parameters())  # frozen by default
    with torch.no_grad():
        logits = model(torch.zeros(1, 1, 32, 32, 6))
    assert logits.shape == (1, 32, 32, config.num_classes) and torch.isfinite(logits).all()


def test_predictor_folds_time_into_channels_frame_major():
    """(B, T, H, W, C) tiles fold to (B, H, W, T*C) frame-major, as the JAX
    trainer's _model_input does for stack_time_into_channels."""
    from s2tpu_torch.data.augment import normalize
    from s2tpu_torch.infer.predict import Predictor
    from s2tpu_torch.models.efficientnet_unet import EfficientNetUNet, EfficientNetUNetConfig

    rng = np.random.default_rng(11)
    raw = rng.integers(0, 3000, size=(2, 2, 32, 32, 6)).astype(np.int16)
    mean, std = np.full(6, 1500.0, np.float32), np.full(6, 800.0, np.float32)
    model = EfficientNetUNet(EfficientNetUNetConfig(version="b0", in_channels=12, num_classes=4))
    predictor = Predictor(model, mean, std, torch.float32, torch.device("cpu"), stack_time_into_channels=True)
    folded = raw.transpose(0, 2, 3, 1, 4).reshape(2, 32, 32, 12)
    with torch.inference_mode():
        expected = model(normalize(torch.from_numpy(folded), torch.from_numpy(np.tile(mean, 2)),
                                   torch.from_numpy(np.tile(std, 2)), torch.float32))
    np.testing.assert_array_equal(predictor(torch.from_numpy(raw)).numpy(), expected.numpy())
    with pytest.raises(ValueError):
        Predictor(model, mean, std, torch.float32, torch.device("cpu"))(torch.from_numpy(raw))
