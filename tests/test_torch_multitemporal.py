"""Multi-temporal segmentation (BASELINE config #3, ``--stack-time``) in s2tpu_torch against the JAX package, on the CPU.

The port folds (B, T, H, W, C) frames into channels frame-major for the
single-frame UNet, as ``s2tpu``'s trainer does (``tests/test_multitemporal.py``
holds the JAX side). The fold is a permute, so it is held exactly; the
stacked B0's f32 logits agree with the Flax model's within LOGITS_ATOL
(the two sum in other orders through ~40 conv layers; the same bound as
``tests/test_torch_unet.py``), and their argmax on ARGMAX_AGREEMENT of the
pixels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.cli.train_segmentation import build_parser as jax_parser
from s2tpu.cli.train_segmentation import config_from_args as jax_config_from_args
from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.models.efficientnet_unet import EfficientNetUNet as JaxUNet
from s2tpu.models.efficientnet_unet import EfficientNetUNetConfig as JaxConfig
from s2tpu.train.trainer import SegmentationTrainer as JaxTrainer
from s2tpu_torch.checkpoint import io
from s2tpu_torch.checkpoint.convert import unet_state_dict_from_jax
from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.data.augment import model_input
from s2tpu_torch.data.dataset import make_synthetic_fixture
from s2tpu_torch.data.pipeline import Datamodule
from s2tpu_torch.models import efficientnet_unet as tu

LOGITS_ATOL = 1e-3
ARGMAX_AGREEMENT = 0.999
CONFIG3_ARGV = ["small", "cnes-multiclass", "efficientnet-unet-b5", "--time-frames", "4", "--stack-time",
                "--bands", "all12"]


def test_stack_time_cli_flags_give_a_48_channel_b5():
    config = config_from_args(build_parser().parse_args(CONFIG3_ARGV))
    ds = config.datamodule.dataset_cfg
    assert ds.n_time_frames == 4 and ds.stack_time_into_channels and not ds.squeeze_time_dim
    model = config.build_model(device="cpu")
    assert model.config.in_channels == 48  # 4 frames x 12 bands
    assert model.encoder.stem[0].weight.shape[1] == 48


def test_stack_time_cli_config_matches_the_jax_cli(tmp_path):
    """The config #3 command line builds the same config tree in both CLIs
    (the run name's random part aside)."""
    argv = CONFIG3_ARGV + ["--loss-type", "focal", "--weighted-loss", "--bs", "32", "--crop", "224",
                           "--compute-dtype", "bfloat16", "--data-dir", str(tmp_path), "--name", "c3", "--auto-resume"]
    theirs = dataclasses.asdict(jax_config_from_args(jax_parser().parse_args(argv)))
    ours = dataclasses.asdict(config_from_args(build_parser().parse_args(argv)))
    assert ours == theirs


def test_fold_order_matches_the_jax_trainer():
    """Frame-major: output channel t*C + c is frame t, band c; the port's
    fold equals the JAX trainer's ``_model_input`` exactly."""
    jcfg = jax_cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    jcfg.datamodule.dataset_cfg.n_time_frames = 3
    jcfg.datamodule.dataset_cfg.stack_time_into_channels = True
    jcfg.__post_init__()
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 4, 6)).astype(np.float32)
    want = np.asarray(JaxTrainer._model_input(type("T", (), {"config": jcfg})(), jnp.asarray(x)))
    got = model_input(torch.from_numpy(x), stack_time_into_channels=True, squeeze_time_dim=False).numpy()
    assert got.shape == want.shape == (2, 5, 4, 18)
    np.testing.assert_array_equal(got, want)
    for t in range(3):
        np.testing.assert_array_equal(got[..., t * 6 : (t + 1) * 6], x[:, t])


def test_flips_are_consistent_across_frames(tmp_path):
    """Host flips reverse W (or H) on every frame and on the labels alike."""
    make_synthetic_fixture(tmp_path, aoi="small", label_map="osm-multiclass", n_segments=2, n_time=3, size=(16, 16))
    c = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    c.datamodule.dataset_cfg.data_dir = str(tmp_path)
    c.datamodule.dataset_cfg.n_time_frames = 3
    c.datamodule.dataset_cfg.stack_time_into_channels = True
    c.datamodule.random_crop_size = 8
    c.__post_init__()
    dm = Datamodule(c.datamodule)
    idx, ys, xs = np.array([0, 1]), np.array([2, 4]), np.array([3, 1])
    plain = dm._gather_crops(idx, ys, xs)
    flip = np.array([True, True])
    h = dm._gather_crops(idx, ys, xs, flip_h=flip)
    v = dm._gather_crops(idx, ys, xs, flip_v=flip)
    assert plain.images.shape == (2, 3, 8, 8, 6)
    np.testing.assert_array_equal(h.images, plain.images[..., :, ::-1, :])
    np.testing.assert_array_equal(h.labels, plain.labels[:, :, ::-1])
    np.testing.assert_array_equal(v.images, plain.images[..., ::-1, :, :])
    np.testing.assert_array_equal(v.labels, plain.labels[:, ::-1, :])


def test_multitemporal_unet_without_stacking_is_refused():
    c = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    c.datamodule.dataset_cfg.n_time_frames = 4
    with pytest.raises(AssertionError, match="stack_time_into_channels"):
        c.__post_init__()
    with pytest.raises(AssertionError, match="--stack-time"):
        config_from_args(build_parser().parse_args(["small", "osm-multiclass", "efficientnet-unet-b0",
                                                    "--time-frames", "4"]))


def test_stacked_b0_logits_match_flax():
    """A B0 on a stacked T=2 x 12-band input (24 channels) at 64², f32: the
    Flax model on the JAX trainer's fold against the port on its own."""
    cfg = JaxConfig(version="b0", in_channels=24, num_classes=4, class_distribution=(0.1, 0.2, 0.3, 0.4))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 2, 64, 64, 12)).astype(np.float32)
    variables = jax.jit(lambda: JaxUNet(cfg).init(jax.random.key(0), jnp.zeros((1, 64, 64, 24)), train=False))()
    params = jax.device_get(variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, np.shape(v)) if path[-1].key == "var"
                         else 0.1 * rng.normal(size=np.shape(v))).astype(np.float32),
        jax.device_get(variables["batch_stats"]),
    )
    jcfg = jax_cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    jcfg.datamodule.dataset_cfg.n_time_frames = 2
    jcfg.datamodule.dataset_cfg.stack_time_into_channels = True
    jcfg.__post_init__()
    folded = JaxTrainer._model_input(type("T", (), {"config": jcfg})(), jnp.asarray(x))
    want = np.asarray(jax.jit(lambda v, x: JaxUNet(cfg).apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, folded))

    model = tu.EfficientNetUNet(tu.EfficientNetUNetConfig(version="b0", in_channels=24, num_classes=4))
    model.load_state_dict(unet_state_dict_from_jax(params, stats), strict=True)
    with torch.inference_mode():
        got = model(model_input(torch.from_numpy(x), stack_time_into_channels=True, squeeze_time_dim=False)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 4)
    assert np.abs(want).max() > 0.1  # O(1) logits, not a degenerate comparison
    assert np.abs(got - want).max() <= LOGITS_ATOL
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= ARGMAX_AGREEMENT


def test_stacked_cli_trains_and_serves_on_the_cpu(tmp_path, monkeypatch):
    """The config #3 command line at B0 and small size: 2 epochs on a
    12-band T=2 CNES fixture, then tiled serving of the run directory."""
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.cli.train_segmentation import main as train_main
    from s2tpu_torch.configs import paths
    from s2tpu_torch.geo.tiff import read_geotiff

    data = tmp_path / "data"
    make_synthetic_fixture(data, aoi="small", label_map="cnes-multiclass", n_segments=5, n_time=2, n_bands=12,
                           size=(96, 96))
    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    argv = [
        "small", "cnes-multiclass", "efficientnet-unet-b0", "--time-frames", "2", "--stack-time", "--bands",
        "all12", "--loss-type", "focal", "--weighted-loss", "--bs", "2", "--crop", "64", "--compute-dtype",
        "float32", "--epochs", "2", "--data-dir", str(data), "--name", "c3", "--device", "cpu",
    ]
    history = train_main(argv)
    assert [r["epoch"] for r in history] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["val/loss"]) for r in history)
    (run_dir,) = (tmp_path / "ckpts").glob("*/c3_*")
    config, state = io.load_checkpoint(run_dir)
    assert config.datamodule.dataset_cfg.stack_time_into_channels
    assert state["encoder.stem.0.weight"].shape[1] == 24  # 2 frames x 12 bands

    out = infer_main([str(run_dir), "--tiled", "--device", "cpu", "--out", str(tmp_path / "preds"),
                      "--data-dir", str(data)])
    preds = sorted(out.glob("pred_*.tif"))
    assert len(preds) == 1  # one val segment of five
    raster, _ = read_geotiff(preds[0])
    assert raster.shape == (1, 96, 96) and raster.max() < config.num_classes


def test_stacked_corpus_epoch_equals_the_streamed_epoch():
    """Config #3's layout from the device corpus: a (N, T, H, W, C) corpus,
    every frame of a sample cropped and flipped together on the device,
    stacked frame-major, trains the same steps as the host stream with
    ``host_flips=False`` (B0, T=2 x 12 bands, 32^2 crops), bit for bit."""
    from s2tpu_torch.data.dataset import Sample, SegmentSource
    from s2tpu_torch.train.trainer import SegmentationTrainer

    rng = np.random.default_rng(4)
    xs = rng.integers(0, 3000, size=(6, 2, 48, 48, 12)).astype(np.int16)
    ys = rng.integers(0, 10, size=(6, 48, 48)).astype(np.uint8)

    class Source(SegmentSource):
        def __len__(self) -> int:
            return len(xs)

        def __getitem__(self, i: int) -> Sample:
            return Sample(xs[i], ys[i])

    states, losses = [], []
    for corpus in (True, False):
        c = config_from_args(build_parser().parse_args([
            "small", "cnes-multiclass", "efficientnet-unet-b0", "--time-frames", "2", "--stack-time", "--bands",
            "all12", "--bs", "2", "--crop", "32", "--compute-dtype", "float32", "--watch-interval", "0",
        ]))
        c.datamodule.data_split, c.datamodule.host_flips, c.train.device_corpus = (1.0, 0.0, 0.0), False, corpus
        c.train.class_distribution = [0.1] * c.num_classes
        dm = Datamodule(c.datamodule, source=Source())
        dm.set_mean_std(np.full(12, 1500.0, np.float32), np.full(12, 800.0, np.float32))
        trainer = SegmentationTrainer(c, dm, device="cpu")
        assert trainer.device_flips and (trainer.corpus is not None) == corpus
        losses.append(trainer.run_train_epoch(0)["loss"])
        states.append(trainer.model.state_dict())
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[1])
