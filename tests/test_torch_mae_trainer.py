"""The Prithvi MAE pretraining slice as a whole: s2tpu_torch's MAETrainer and CLI vs the JAX package's.

A tiny Prithvi MAE (the route's plain and fused paths; f32 on the CPU)
whose Flax parameters are carried into the port; both trainers see the same
int16 crops (augmentation off) and the same masking noise (the JAX step's
key, drawn in the test and handed to the port).

Tolerances: the loss to 1e-5 relative (f32, sums in other orders). Adam's
first update is lr · g'/(|g'| + eps) with g' = g + wd·p, so each parameter
moves by about lr in the direction of g': the updated parameters agree to
1e-3·lr wherever |g'| is well above f32 rounding of g (1e-6 here), and the
few entries with |g'| below that may differ by at most 2·lr.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.configs import mae as jax_mae_cfg
from s2tpu.configs.segmentation import DatamoduleConfig as JaxDatamoduleConfig
from s2tpu.configs.segmentation import DatasetConfig as JaxDatasetConfig
from s2tpu.data.dataset import TiffSource as JaxTiffSource
from s2tpu.data.pipeline import Datamodule as JaxDatamodule
from s2tpu.models.prithvi_mae import PrithviConfig as JaxPrithviConfig
from s2tpu.parallel import mesh as mesh_lib
from s2tpu.train.mae_trainer import MAETrainer as JaxMAETrainer
from s2tpu_torch.checkpoint import io
from s2tpu_torch.checkpoint.convert import prithvi_state_dict_from_jax
from s2tpu_torch.configs import mae as mae_cfg
from s2tpu_torch.configs.segmentation import DatamoduleConfig, DatasetConfig
from s2tpu_torch.data.dataset import TiffSource
from s2tpu_torch.data.pipeline import Datamodule
from s2tpu_torch.models.prithvi_mae import PrithviConfig
from s2tpu_torch.train import mae_trainer
from s2tpu_torch.train.mae_trainer import MAETrainer

# Encoder L = 16·0.5 + 1 = 9 (plain), decoder L = 17 (plain); a second
# geometry at 64² / patch 4 reaches the fused route (L = 129 and 257).
TINY = dict(img_size=32, patch_size=8, num_frames=1, tubelet_size=1, in_chans=6, embed_dim=64, depth=2,
            num_heads=4, decoder_embed_dim=48, decoder_depth=1, decoder_num_heads=4, attention_impl="fused")
LR = 1e-3


def _configs(fixture_dir, crop: int, batch: int):
    out = []
    for lib in (jax_mae_cfg, mae_cfg):
        c = lib.base_config(aoi="small")
        c.datamodule.dataset_cfg.data_dir = str(fixture_dir)
        c.datamodule.batch_size = batch
        c.datamodule.random_crop_size = crop
        c.datamodule.data_split = (0.5, 0.5, 0.0)
        c.datamodule.augment = False
        c.model.mask_ratio = 0.5
        c.train.from_scratch = True
        c.train.lr = LR
        out.append(c)
    return out


def _datamodules(fixture_dir, crop: int, batch: int):
    jdm = JaxDatamodule(
        JaxDatamoduleConfig(
            dataset_cfg=JaxDatasetConfig(aoi="small", label_map="osm-multiclass", data_dir=str(fixture_dir)),
            batch_size=batch, data_split=(0.5, 0.5, 0.0), random_crop_size=crop, augment=False,
        ),
        source=JaxTiffSource("small", "osm-multiclass", data_dir=fixture_dir, require_labels=False),
    )
    dm = Datamodule(
        DatamoduleConfig(
            dataset_cfg=DatasetConfig(aoi="small", label_map="osm-multiclass", data_dir=str(fixture_dir)),
            batch_size=batch, data_split=(0.5, 0.5, 0.0), random_crop_size=crop, augment=False,
        ),
        source=TiffSource("small", "osm-multiclass", data_dir=fixture_dir, require_labels=False),
    )
    return jdm, dm


def _trainers(fixture_dir, geometry: dict):
    crop = geometry["img_size"]
    jc, pc = _configs(fixture_dir, crop, batch=2)
    jdm, dm = _datamodules(fixture_dir, crop, batch=2)
    jt = JaxMAETrainer(jc, jdm, mesh=mesh_lib.make_mesh(1), model_config=JaxPrithviConfig(**geometry))
    pt = MAETrainer(pc, dm, model_config=PrithviConfig(**geometry), device="cpu")
    pt.model.load_state_dict(prithvi_state_dict_from_jax(jax.device_get(jt.state.params), pt.model_config), strict=True)
    return jt, pt


@pytest.mark.parametrize("geometry", [TINY, dict(TINY, img_size=64, patch_size=4)], ids=["plain", "fused"])
def test_one_train_step_equals_the_jax_trainer(fixture_dir, geometry):
    jt, pt = _trainers(fixture_dir, geometry)
    params0 = jax.device_get(jt.state.params)
    batch = next(jt.dm.train_batches(0))
    assert np.array_equal(batch.images, next(pt.dm.train_batches(0)).images)  # same crops on both sides
    # The JAX step's masking noise: fold the step into the base key, split, draw.
    _, mask_key = jax.random.split(jax.random.fold_in(jt.base_rng, 0))
    noise = np.array(jax.random.uniform(mask_key, (2, pt.model_config.num_patches)))

    state, jm = jt.train_step(jt.state, jnp.asarray(batch.images), jt.base_rng)
    m = pt.train_step(torch.from_numpy(batch.images), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert pt.step == 1

    before = prithvi_state_dict_from_jax(params0, pt.model_config)
    after_jax = prithvi_state_dict_from_jax(jax.device_get(state.params), pt.model_config)
    for name, p in pt.model.named_parameters():
        ours = (p.detach() - before[name]) / LR
        theirs = (after_jax[name] - before[name]) / LR
        g = p.grad + 0.05 * before[name]  # g' of coupled L2 (wd 0.05)
        clear = g.abs() > 1e-6
        assert float(torch.where(clear, ours - theirs, 0.0).abs().max()) <= 1e-3, name
        assert float((ours - theirs).abs().max()) <= 2.0 + 1e-3, name


def test_eval_loss_leaves_out_padded_rows(fixture_dir, monkeypatch):
    jt, pt = _trainers(fixture_dir, TINY)
    batch = next(jt.dm.eval_batches("val"))  # 3 val segments in a padded batch of 4
    assert batch.mask.tolist() == [True, True, True, False]
    # The JAX eval step masks with its base key for every batch.
    noise = np.array(jax.random.uniform(jt.base_rng, (4, pt.model_config.num_patches)))
    monkeypatch.setattr(pt, "_noise", lambda b, seed: torch.from_numpy(noise[:b]))
    jm = jt.eval_step(jt.state, jnp.asarray(batch.images), jnp.asarray(batch.mask, jnp.float32), jt.base_rng)
    m = pt.eval_step(torch.from_numpy(batch.images), torch.from_numpy(batch.mask))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["weight"]), 0.75)
    valid = pt.eval_step(torch.from_numpy(batch.images[:3]), torch.ones(3, dtype=torch.bool))
    np.testing.assert_allclose(float(m["loss"]), float(valid["loss"]), rtol=1e-6)
    assert pt.run_eval_epoch("val")["loss"] == pytest.approx(float(m["loss"]), rel=1e-6)
    rec = pt.reconstruct(batch.images[:1])
    assert rec.shape == (1, 1, 32, 32, 6) and np.isfinite(rec).all()


def _tiny_model_config(config):
    """The CLI's model at test size: Prithvi's geometry rules, tiny widths."""
    return PrithviConfig(**dict(TINY, num_frames=config.model.num_frames, img_size=config.datamodule.random_crop_size))


def test_cli_trains_checkpoints_and_resumes_on_cpu(fixture_dir, tmp_path, monkeypatch):
    from s2tpu_torch.cli.train_mae import main
    from s2tpu_torch.configs import paths

    monkeypatch.setattr(mae_trainer, "default_model_config", _tiny_model_config)
    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    argv = ["small", "--type", "pretrain", "--from-scratch", "--bs", "2", "--crop", "32", "--epochs", "2",
            "--log-interval", "1", "--compute-dtype", "float32", "--data-dir", str(fixture_dir), "--name", "t",
            "--wandb", "--device", "cpu"]
    history = main(argv)
    assert [r["epoch"] for r in history] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["val/loss"]) for r in history)
    # the pretrain rule at the preset's batch of 64 (--bs changes the batch after the preset, as in JAX)
    assert history[0]["train/lr"] == pytest.approx(1.5e-4 * 64 / 256)
    (run_dir,) = (tmp_path / "ckpts" / "prithvi-mae-finetune").glob("t_*")
    config, state = io.load_mae_checkpoint(run_dir)
    assert config.datamodule.batch_size == 2 and config.train.watch_interval == mae_cfg.MAETrainConfig().watch_interval
    assert "patch_embed.proj.weight" in state and all(v.dtype == torch.float32 for v in state.values())
    steps = [json.loads(line) for line in (tmp_path / "logs" / "runs" / f"{run_dir.name}.metrics.jsonl").open()]
    assert sum("train/loss_step" in s for s in steps) == 4  # 4 train segments (of 6, split 0.8) / bs 2, 2 epochs

    resumed = main(argv + ["--epochs", "3", "--resume-from", str(run_dir)])
    assert [r["epoch"] for r in resumed] == [2]
    assert io.CheckpointManager(run_dir).restore(2)["step"] == 6


def test_cli_num_frames_reaches_the_source_and_the_model(tmp_path, monkeypatch):
    from s2tpu_torch.cli.train_mae import main
    from s2tpu_torch.configs import paths
    from s2tpu_torch.data.dataset import make_synthetic_fixture

    make_synthetic_fixture(tmp_path / "data", n_segments=5, n_time=2, size=(48, 48))
    monkeypatch.setattr(mae_trainer, "default_model_config", _tiny_model_config)
    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    seen = []
    step = MAETrainer.train_step
    monkeypatch.setattr(MAETrainer, "train_step", lambda self, images, noise=None: seen.append(tuple(images.shape)) or step(self, images, noise))
    history = main(["small", "--type", "pretrain", "--from-scratch", "--bs", "2", "--crop", "32", "--epochs", "1",
                    "--num-frames", "2", "--compute-dtype", "float32", "--data-dir", str(tmp_path / "data"),
                    "--wandb", "--device", "cpu"])
    assert seen == [(2, 2, 32, 32, 6)] * 2 and np.isfinite(history[0]["train/loss"])
    (run_dir,) = (tmp_path / "ckpts" / "prithvi-mae-finetune").glob("*")
    config, _ = io.load_mae_checkpoint(run_dir)
    assert config.model.num_frames == 2 and config.datamodule.dataset_cfg.n_time_frames == 2


def test_cli_config_matches_the_jax_cli(tmp_path):
    """The flags both CLIs take build the same config tree."""
    from s2tpu.cli.train_mae import build_parser as jax_parser
    from s2tpu.cli.train_mae import config_from_args as jax_config_from_args
    from s2tpu_torch.cli.train_mae import build_parser, config_from_args

    argv = ["fr", "--type", "pretrain", "--from-scratch", "--bs", "16", "--lr", "3e-4", "--epochs", "7",
            "--log-interval", "5", "--num-frames", "3", "--crop", "128", "--bands", "all12", "--mask-ratio", "0.6",
            "--name", "x", "--wandb", "--tags", "a", "b", "--compute-dtype", "bfloat16", "--data-dir",
            str(tmp_path), "--seed", "7", "--auto-resume", "--ema-decay", "0.999", "--grad-accum", "2", "--remat",
            "--device-corpus", "--steps-per-dispatch", "3"]
    theirs = dataclasses.asdict(jax_config_from_args(jax_parser().parse_args(argv)))
    ours = dataclasses.asdict(config_from_args(build_parser().parse_args(argv)))
    assert ours == theirs
    parsed = config_from_args(build_parser().parse_args(argv))
    assert mae_cfg.config_from_dict(json.loads(json.dumps(dataclasses.asdict(parsed)))) == parsed


def test_cli_without_cuda_raises_unless_cpu_is_asked(monkeypatch, fixture_dir):
    from s2tpu_torch.cli.train_mae import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["small", "--from-scratch", "--data-dir", str(fixture_dir)])


@pytest.mark.parametrize(
    "flags", [["--pp", "2"], ["--pp-microbatches", "2"], ["--pp", "2", "--device-corpus-sharded"],
              ["--num-devices", "4", "--pp", "2"]]
)
def test_cli_refuses_unported_flags(flags, monkeypatch):
    """The pipeline flags, refused here until GPipe was ported, reach the
    run: ``--pp S`` needs ``--num-devices`` ranks that S divides, so one
    process refuses it before any data work (also beside the sharded
    corpus); ``--pp-microbatches`` sets the config's micro-batches; ``--pp 2
    --num-devices 4`` starts four ranks, each of which builds a 2 x 2 mesh
    (tests/test_torch_pipeline_parallel.py trains ``--pp 2 --num-devices 2``
    on two)."""
    from s2tpu_torch.cli import train_mae
    from s2tpu_torch.parallel import multihost

    args = train_mae.build_parser().parse_args(["small", *flags])
    config = train_mae.config_from_args(args)
    assert (config.model.pipeline_stages, config.model.pipeline_microbatches) == (
        int(flags[flags.index("--pp") + 1]) if "--pp" in flags else 1, 2)
    spawned = []
    monkeypatch.setattr(multihost, "spawn_ranks", lambda main, argv, n, device: spawned.append((n, argv)))
    monkeypatch.setattr(train_mae, "build_datamodule", lambda config: pytest.fail("a one-process run went on"))
    if "--num-devices" in flags:
        train_mae.main(["small", *flags, "--device", "cpu"])
        assert spawned == [(4, ["small", *flags, "--device", "cpu"])]
    elif "--pp" in flags:
        with pytest.raises(SystemExit, match="--pp 2 needs --num-devices N divisible by 2"):
            train_mae.main(["small", *flags, "--device", "cpu"])
    else:
        with pytest.raises(pytest.fail.Exception, match="a one-process run went on"):
            train_mae.main(["small", *flags, "--device", "cpu"])


# The flags refused until their features were ported now train: each case
# runs the CLI for one epoch and finds its fields in the run's config.
PORTED_FLAGS = [
    (["--remat"], {"remat": True}),
    (["--ema-decay", "0.99"], {"ema_decay": 0.99}),
    (["--grad-accum", "2"], {"grad_accum_steps": 2}),
    (["--device-corpus"], {"device_corpus": True}),
    (["--device-corpus", "--steps-per-dispatch", "2", "--watch-interval", "0"],
     {"device_corpus": True, "steps_per_dispatch": 2, "watch_interval": 0}),
    (["--device-corpus-sharded"], {"device_corpus": True, "device_corpus_sharded": True}),
]


@pytest.mark.parametrize("flags,fields", PORTED_FLAGS)
def test_cli_trains_ported_flags(flags, fields, fixture_dir, tmp_path, monkeypatch):
    from s2tpu_torch.cli.train_mae import main
    from s2tpu_torch.configs import paths

    monkeypatch.setattr(mae_trainer, "default_model_config", _tiny_model_config)
    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    history = main(["small", "--type", "pretrain", "--from-scratch", "--bs", "2", "--crop", "32", "--epochs", "1",
                    "--compute-dtype", "float32", "--data-dir", str(fixture_dir), "--wandb", "--device", "cpu", *flags])
    assert np.isfinite(history[0]["train/loss"])
    (run_dir,) = (tmp_path / "ckpts" / "prithvi-mae-finetune").glob("*")
    t = io.load_mae_checkpoint(run_dir)[0].train
    assert {k: getattr(t, k) for k in fields} == fields


# What the trainer refuses: pipeline stages without a model axis of as many
# ranks (tests/test_torch_pipeline_parallel.py trains them on one) and,
# outside a process group of as many ranks, num_devices other than 1 and -1
# (a data axis: the error names the launch that starts the ranks). The
# sharded corpus, refused until it was ported, is on one process the plain
# corpus, as in the JAX trainer (tests/test_torch_sharded_corpus.py holds it
# on a data axis).
@pytest.mark.parametrize(
    "section,field,value",
    [("model", "pipeline_stages", 2), ("train", "device_corpus_sharded", True), ("train", "num_devices", 4)],
)
def test_trainer_refuses_unported_config_fields(section, field, value, fixture_dir):
    c = mae_cfg.base_config("small")
    setattr(getattr(c, section), field, value)
    if field == "device_corpus_sharded":
        _, pc = _configs(fixture_dir, 32, 2)
        pc.train.device_corpus = pc.train.device_corpus_sharded = True
        _, dm = _datamodules(fixture_dir, 32, 2)
        t = MAETrainer(pc, dm, model_config=PrithviConfig(**TINY), device="cpu")
        assert not t.corpus.sharded and t.corpus.labels is None and t.corpus.images.shape[0] == len(dm.source)
        return
    if field == "num_devices":
        with pytest.raises(RuntimeError, match="num_devices=4 needs a process group of 4 ranks.*torchrun"):
            MAETrainer(c, datamodule=None, device="cpu")
        return
    with pytest.raises(ValueError, match="pipeline_stages=2 needs a mesh whose model axis holds 2 ranks"):
        MAETrainer(c, datamodule=None, device="cpu")


# The fields once refused train now (one step each, or one epoch from the
# corpus; every parameter moves).
@pytest.mark.parametrize(
    "field,value",
    [("grad_accum_steps", 2), ("remat", True), ("ema_decay", 0.99), ("param_dtype", "bfloat16"),
     ("device_corpus", True), ("steps_per_dispatch", 2)],
)
def test_trainer_trains_ported_config_fields(field, value, fixture_dir):
    _, pc = _configs(fixture_dir, 32, 2)
    setattr(pc.train, field, value)
    if field == "steps_per_dispatch":
        pc.train.device_corpus = True
    _, dm = _datamodules(fixture_dir, 32, 2)
    t = MAETrainer(pc, dm, model_config=PrithviConfig(**TINY), device="cpu")
    before = {n: p.detach().float().clone() for n, p in t.model.named_parameters()}
    if pc.train.device_corpus:
        m = t.run_train_epoch(0)  # 3 train segments: one step from the corpus
        assert t.corpus is not None and t.corpus.labels is None
    else:
        m = t.train_step(torch.from_numpy(next(dm.train_batches(0)).images))
    assert np.isfinite(float(m["loss"])) and t.step == 1
    # every parameter moved (under bf16 storage its f32 master: an update of
    # lr may be below a bf16 parameter's resolution)
    after = t.master.master if t.master is not None else dict(t.model.named_parameters())
    assert all(not torch.equal(before[n], a.detach().float()) for n, a in after.items())
    if field == "remat":
        assert t.model.remat
    if field == "ema_decay":
        assert t.ema is not None and t.ema.decay == value
    if field == "param_dtype":
        assert {p.dtype for p in t.model.parameters()} == {torch.bfloat16}
        assert all(m.dtype == torch.float32 for m in t.master.master.values())


def test_trainer_watches_norms_with_a_run_logger(fixture_dir, tmp_path):
    """Norm watching, once refused with a run logger, now logs the global and
    per-tensor norms every watch_interval steps (here every step)."""
    from s2tpu_torch.train.logging_utils import RunLogger

    _, pc = _configs(fixture_dir, 32, 2)
    pc.train.watch_interval = 1
    _, dm = _datamodules(fixture_dir, 32, 2)
    t = MAETrainer(pc, dm, model_config=PrithviConfig(**TINY), run_logger=RunLogger("r", tmp_path), device="cpu")
    t.run_train_epoch(0)
    t.run_train_epoch(1)
    lines = [json.loads(line) for line in (tmp_path / "r.metrics.jsonl").read_text().splitlines()]
    watched = [line for line in lines if "grads/global_norm" in line]
    assert [line["step"] for line in watched] == [1, 2]  # 3 train segments: one step of 2 a epoch
    names = [n for n, _ in t.model.named_parameters()]
    assert all(f"grads/{n}" in watched[0] and f"params/{n}" in watched[0] for n in names)
    assert all(np.isfinite(v) and v > 0 for v in watched[-1].values())


def test_finetune_without_published_weights_warns_and_keeps_random_init(fixture_dir, tmp_path, monkeypatch, caplog):
    from s2tpu_torch.configs import paths

    monkeypatch.setattr(paths, "WEIGHTS_DIR", tmp_path / "weights")
    _, pc = _configs(fixture_dir, 32, 2)
    pc.train.from_scratch = False
    _, dm = _datamodules(fixture_dir, 32, 2)
    with caplog.at_level("WARNING"):
        t = MAETrainer(pc, dm, model_config=PrithviConfig(**TINY), device="cpu")
    assert "Pretrained Prithvi weights unavailable" in caplog.text
    ref = MAETrainer(pc, dm, model_config=PrithviConfig(**TINY), device="cpu")
    for (n, a), (_, b) in zip(t.model.state_dict().items(), ref.model.state_dict().items()):
        assert torch.equal(a, b), n  # the seeded random init
