"""Epoch image logging: s2tpu_torch.plotting and RunLogger.log_image against the JAX package's, and the trainers' images.

The plotting functions render the JAX package's pixels (the same
matplotlib calls on the same arrays, compared exactly); ``log_image`` writes
the same files. Image logging must not touch training: a trainer's state
after epochs with images equals, bit for bit, its state without them (its
forwards run in eval mode under no_grad from the eval weights, drawing from
none of the step's generators). Where matplotlib cannot be imported, a
trainer warns once, writes no image and runs no extra forward. B0 at 64^2
crops and a tiny Prithvi MAE at 32^2, f32, on the CPU.
"""

import logging
import sys

import numpy as np
import pytest
import torch

from s2tpu import plotting as jax_plotting
from s2tpu.configs.data_config import LABEL_MAPS as JAX_LABEL_MAPS
from s2tpu.train.logging_utils import RunLogger as JaxRunLogger
from s2tpu_torch import plotting
from s2tpu_torch.configs import mae as mae_cfg
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.configs.data_config import LABEL_MAPS
from s2tpu_torch.configs.segmentation import DatamoduleConfig, DatasetConfig
from s2tpu_torch.data.dataset import TiffSource
from s2tpu_torch.data.pipeline import Datamodule
from s2tpu_torch.models.prithvi_mae import PrithviConfig
from s2tpu_torch.train import mae_trainer
from s2tpu_torch.train.logging_utils import RunLogger
from s2tpu_torch.train.mae_trainer import MAETrainer
from s2tpu_torch.train.trainer import SegmentationTrainer
from tests.test_torch_mae_trainer import TINY, _tiny_model_config

SEG_PNGS = ("val_confusion_matrix", "val_segmentation", "val_fixed_prediction_dynamics")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch CPU threads in this module, as the suite's other trainer
    modules hold them (several workers share the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _pixels(fig) -> np.ndarray:
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plotting.pyplot().close(fig)
    return out


def test_stretch_rgb_and_colormaps_equal_the_jax_package():
    rng = np.random.default_rng(0)
    img = rng.integers(-500, 6000, size=(6, 40, 48)).astype(np.int16)
    for bands in ((2, 1, 0), (0, 1, 2), (5, 3, 1)):
        ours = plotting.stretch_rgb(img, bands)
        assert ours.dtype == np.uint8 and ours.shape == (40, 48, 3)
        np.testing.assert_array_equal(ours, jax_plotting.stretch_rgb(img, bands))
    np.testing.assert_array_equal(plotting.stretch_rgb(np.full((3, 4, 4), 7, np.int16)),
                                  jax_plotting.stretch_rgb(np.full((3, 4, 4), 7, np.int16)))  # a flat image
    assert sorted(LABEL_MAPS) == sorted(JAX_LABEL_MAPS)
    for name in LABEL_MAPS:
        assert plotting.label_colormap(name).colors == jax_plotting.label_colormap(name).colors
        assert plotting.label_colormap(LABEL_MAPS[name]).N == LABEL_MAPS[name].num_classes


@pytest.mark.parametrize("label_map", ["osm-multiclass", "cnes-multiclass"])
def test_figures_render_the_jax_package_pixels(label_map):
    rng = np.random.default_rng(1)
    k = LABEL_MAPS[label_map].num_classes
    rgb = rng.integers(0, 256, size=(32, 32, 3)).astype(np.uint8)
    mask, pred = rng.integers(0, k, size=(2, 32, 32))
    for args in ((rgb, mask, label_map), (rgb, mask, label_map, pred)):
        np.testing.assert_array_equal(_pixels(plotting.plot_sentinel_and_mask(*args)),
                                      _pixels(jax_plotting.plot_sentinel_and_mask(*args)))
    cm = rng.random((k - 1, k - 1))
    names = LABEL_MAPS[label_map].class_names[1:]
    np.testing.assert_array_equal(_pixels(plotting.confusion_matrix_figure(cm, names)),
                                  _pixels(jax_plotting.confusion_matrix_figure(cm, names)))


def test_log_image_writes_the_jax_package_files(tmp_path):
    plt = plotting.pyplot()
    ours, theirs = RunLogger("r", tmp_path / "ours"), JaxRunLogger("r", tmp_path / "theirs", use_wandb=False)
    image = np.random.default_rng(2).integers(0, 256, size=(16, 24, 3)).astype(np.uint8)
    for logger in (ours, theirs):
        logger.log_image("val/array", image, 3)
        logger.log_image("val/figure", plotting.plot_sentinel_and_mask(image, image[..., 0] % 4, "osm-multiclass"), 5)
    names = sorted(p.name for p in (tmp_path / "theirs" / "r").iterdir())
    assert names == ["val_array_3.png", "val_figure_5.png"]
    assert sorted(p.name for p in (tmp_path / "ours" / "r").iterdir()) == names
    for name in names:
        np.testing.assert_array_equal(plt.imread(tmp_path / "ours" / "r" / name),
                                      plt.imread(tmp_path / "theirs" / "r" / name))
    assert plt.get_fignums() == []  # figures are closed after saving


def _seg_trainer(fixture_dir, run_logger, **train) -> SegmentationTrainer:
    c = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    c.datamodule.dataset_cfg.data_dir = str(fixture_dir)
    c.datamodule.batch_size = 2
    c.datamodule.random_crop_size = 64
    c.datamodule.data_split = (0.5, 0.5, 0.0)
    c.train.compute_dtype = "float32"
    c.train.watch_interval = 0
    c.train.log_interval = 100
    c.train.class_distribution = [0.0, 0.4, 0.3, 0.3]
    for k, v in train.items():
        setattr(c.train, k, v)
    dm = Datamodule(c.datamodule)
    dm.set_mean_std(np.full(6, 1500.0, np.float32), np.full(6, 500.0, np.float32))
    return SegmentationTrainer(c, dm, run_logger=run_logger, device="cpu")


def _mae_trainer(fixture_dir, run_logger) -> MAETrainer:
    c = mae_cfg.base_config(aoi="small")
    c.datamodule.dataset_cfg.data_dir = str(fixture_dir)
    c.datamodule.batch_size = 2
    c.datamodule.random_crop_size = 32
    c.datamodule.data_split = (0.5, 0.5, 0.0)
    c.model.mask_ratio = 0.5
    c.train.from_scratch = True
    c.train.watch_interval = 0
    c.train.log_interval = 100
    dm = Datamodule(
        DatamoduleConfig(dataset_cfg=DatasetConfig(aoi="small", label_map="osm-multiclass", data_dir=str(fixture_dir)),
                         batch_size=2, data_split=(0.5, 0.5, 0.0), random_crop_size=32),
        source=TiffSource("small", "osm-multiclass", data_dir=fixture_dir, require_labels=False),
    )
    return MAETrainer(c, dm, model_config=PrithviConfig(**TINY), run_logger=run_logger, device="cpu")


def _state(trainer) -> dict[str, torch.Tensor]:
    out = {f"model.{k}": v for k, v in trainer.model.state_dict().items()}
    for i, st in enumerate(trainer.optimizer.state.values()):
        out.update({f"adam.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    if trainer.ema is not None:
        out.update({f"ema.{k}": v for k, v in trainer.ema.state_dict().items()})
    out.update({f"generator.{i}": g.get_state() for i, g in enumerate(trainer.generators)})
    return out


def _count_forwards(trainer) -> list:
    calls = []
    trainer.model.register_forward_hook(lambda module, args, out: calls.append(module.training))
    return calls


@pytest.mark.parametrize("kind,extra", [("seg", {}), ("seg", {"ema_decay": 0.9}), ("mae", {})],
                         ids=["segmentation", "segmentation-ema", "mae"])
def test_epoch_images_leave_the_trainer_state_bit_for_bit_unchanged(fixture_dir, tmp_path, kind, extra):
    make = (lambda rl: _seg_trainer(fixture_dir, rl, **extra)) if kind == "seg" else \
        (lambda rl: _mae_trainer(fixture_dir, rl))
    logged, plain = make(RunLogger("r", tmp_path)), make(None)
    forwards = _count_forwards(logged), _count_forwards(plain)
    history = logged.fit(epochs=2), plain.fit(epochs=2)
    pngs = sorted(p.name for p in (tmp_path / "r").iterdir())
    steps = [logged.step // 2, logged.step]  # one train step an epoch here
    names = SEG_PNGS if kind == "seg" else ("val_reconstruction",)
    assert pngs == sorted(f"{n}_{s}.png" for n in names for s in steps)
    assert logged.model.training == plain.model.training  # the images put back the mode they found
    ours, ref = _state(logged), _state(plain)
    assert ours.keys() == ref.keys()
    assert [k for k in ref if not torch.equal(ours[k], ref[k])] == []
    assert [{k: v for k, v in r.items() if "images_per_sec" not in k} for r in history[0]] == \
        [{k: v for k, v in r.items() if "images_per_sec" not in k} for r in history[1]]
    # the images' extra forwards are eval forwards, two a segmentation epoch and one an MAE epoch
    assert forwards[0].count(True) == forwards[1].count(True)
    assert forwards[0].count(False) - forwards[1].count(False) == (4 if kind == "seg" else 2)


@pytest.mark.parametrize("kind", ["seg", "mae"], ids=["segmentation", "mae"])
def test_without_matplotlib_one_warning_no_image_and_no_forward(fixture_dir, tmp_path, monkeypatch, caplog, kind):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises ImportError
    assert plotting.pyplot() is None
    make = (lambda rl: _seg_trainer(fixture_dir, rl)) if kind == "seg" else (lambda rl: _mae_trainer(fixture_dir, rl))
    logged, plain = make(RunLogger("r", tmp_path)), make(None)
    forwards = _count_forwards(logged), _count_forwards(plain)
    with caplog.at_level(logging.WARNING):
        logged.fit(epochs=2)
    plain.fit(epochs=2)
    assert caplog.text.count("matplotlib is not installed") == 1
    assert not (tmp_path / "r").exists()
    assert forwards[0] == forwards[1]


def test_cli_runs_write_their_epoch_images(fixture_dir, tmp_path, monkeypatch):
    from s2tpu_torch.cli.train_mae import main as mae_main
    from s2tpu_torch.cli.train_segmentation import main as seg_main
    from s2tpu_torch.configs import paths

    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    monkeypatch.setattr(mae_trainer, "default_model_config", _tiny_model_config)
    seg_main(["small", "osm-multiclass", "efficientnet-unet-b0", "--bs", "2", "--crop", "64", "--compute-dtype",
              "float32", "--epochs", "1", "--data-dir", str(fixture_dir), "--name", "seg", "--device", "cpu"])
    mae_main(["small", "--type", "pretrain", "--from-scratch", "--bs", "2", "--crop", "32", "--epochs", "1",
              "--compute-dtype", "float32", "--data-dir", str(fixture_dir), "--name", "mae", "--wandb",
              "--device", "cpu"])
    (seg_dir,) = (p for p in (tmp_path / "logs" / "runs").glob("seg_*") if p.is_dir())
    assert sorted(p.name for p in seg_dir.iterdir()) == sorted(f"{n}_2.png" for n in SEG_PNGS)  # 4 train / bs 2
    (mae_dir,) = (p for p in (tmp_path / "logs" / "runs").glob("mae_*") if p.is_dir())
    assert [p.name for p in mae_dir.iterdir()] == ["val_reconstruction_2.png"]
    img = plotting.pyplot().imread(mae_dir / "val_reconstruction_2.png")
    assert img.ndim == 3 and img.shape[0] > 100 and np.isfinite(img).all()
