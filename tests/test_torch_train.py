"""The training slice as a whole: s2tpu_torch's train-mode model, trainer and CLI vs the JAX package's.

JAX weights are carried into the port with the converter. Drop-connect is
compared by feeding both sides the same per-sample masks (on the JAX side
``jax.random.bernoulli`` is replaced inside the test). Everything runs on
the CPU in f32: B0, 64^2 crops, batch 2.

Tolerances. Train-mode BatchNorm takes its statistics as E[x^2] - E[x]^2
(flax semantics) over few values per channel at this size (2 x 2 x 2 at the
deepest level), which amplifies f32 rounding: a 1e-7 relative perturbation
of inputs and weights moves the early layers' gradients by about 1 %
(relative L2) while the classifier's stays at f32 rounding, as the f32
train-step phase of chip_smoke.py measures for B5 in every run. Two f32
implementations that sum in other orders therefore agree on gradients to
GRAD_RTOL in relative L2 per tensor, and much closer on the whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.data.pipeline import Datamodule as JaxDatamodule
from s2tpu.models.efficientnet_unet import EfficientNetUNet as JaxUNet
from s2tpu.models.efficientnet_unet import EfficientNetUNetConfig as JaxConfig
from s2tpu.train import losses as jax_losses
from s2tpu.train.trainer import SegmentationTrainer as JaxTrainer
from s2tpu_torch.checkpoint import io
from s2tpu_torch.checkpoint.convert import unet_state_dict_from_jax
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.data.pipeline import Datamodule
from s2tpu_torch.models import efficientnet_unet as tu
from s2tpu_torch.train import losses
from s2tpu_torch.train.trainer import SegmentationTrainer

DIST = (0.1, 0.3, 0.4, 0.2)
# Relative L2 per tensor and of all gradients together (see the module
# docstring): 1e-7 perturbations of the port's own inputs and weights move
# them by up to ~2 % and ~0.8 %, so these leave a margin of 2.5-3x.
GRAD_RTOL = 5e-2
TOTAL_GRAD_RTOL = 2.5e-2


def _masks(n: int, batch: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.random((batch, 1, 1, 1)) < 0.7 for _ in range(n)]


def _feed_masks(monkeypatch, masks: list[np.ndarray]) -> None:
    """Both models draw their drop-connect masks from ``masks``, in block order."""
    jax_queue, torch_queue = list(masks), list(masks)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(jax_queue.pop(0)).reshape(shape))
    monkeypatch.setattr(
        tu, "drop_connect_mask",
        lambda batch, keep, generator, device: torch.from_numpy(torch_queue.pop(0)).reshape(batch, 1, 1, 1),
    )


def _n_drop_blocks(cfg: tu.EfficientNetUNetConfig) -> int:
    n = len(cfg.block_specs)
    return sum(
        1 for i, s in enumerate(cfg.block_specs)
        if s.skip and s.stride == 1 and s.in_filters == s.out_filters and cfg.drop_connect_rate * i / n > 0
    )


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_train_mode_forward_stats_and_grads_match_flax(monkeypatch):
    jcfg = JaxConfig(version="b0", in_channels=6, num_classes=4, class_distribution=DIST)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 64, 6)).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 64, 64)).astype(np.int32)
    variables = jax.jit(lambda: JaxUNet(jcfg).init(jax.random.key(0), jnp.zeros((1, 64, 64, 6)), train=False))()
    params = jax.device_get(variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, np.shape(v)) if path[-1].key == "var"
                         else 0.1 * rng.normal(size=np.shape(v))).astype(np.float32),
        jax.device_get(variables["batch_stats"]),
    )
    pcfg = tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=4, class_distribution=DIST)
    _feed_masks(monkeypatch, _masks(_n_drop_blocks(pcfg), 2, seed=1))
    jloss_fn = jax_losses.make_loss_fn("focal", 4, masked_loss=True, weighted_loss=True, class_distribution=DIST)

    def loss_fn(p):
        logits, mutated = JaxUNet(jcfg).apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(x), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(1)},
        )
        return jloss_fn(logits, jnp.asarray(labels)).total, (logits, mutated["batch_stats"])

    (jloss, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = tu.EfficientNetUNet(pcfg)
    model.load_state_dict(unet_state_dict_from_jax(params, stats), strict=True)
    model.train()
    logits = model(torch.from_numpy(x), generator=torch.Generator())
    loss = losses.make_loss_fn("focal", 4, masked_loss=True, weighted_loss=True, class_distribution=DIST)(
        logits, torch.from_numpy(labels)
    ).total
    loss.backward()

    # Forward: the eval-mode comparison's bound (test_torch_unet) holds here too.
    assert np.abs(logits.detach().numpy() - np.asarray(jlogits)).max() <= 1e-3
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    # Running statistics after the step (biased batch variance, flax decays).
    ref_state = unet_state_dict_from_jax(params, jax.device_get(jstats))
    for name, buf in model.named_buffers():
        if "running" in name:
            err = (buf - ref_state[name]).abs() / ref_state[name].abs().clamp_min(1.0)
            assert float(err.max()) <= 1e-4, name
    # Gradients, mapped to the port's names and layouts by the same converter.
    zero_stats = jax.tree_util.tree_map(np.zeros_like, stats)
    ref_grads = unet_state_dict_from_jax(jax.device_get(jgrads), zero_stats)
    total = torch.cat([g.flatten() for name, g in ref_grads.items() if name in dict(model.named_parameters())]).norm()
    ours, theirs = [], []
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        # A bias followed by a train-mode BatchNorm has a zero gradient up to
        # rounding (~1e-9 here), hence the floor relative to all gradients.
        diff, ref = float((p.grad - ref_grads[name]).norm()), float(ref_grads[name].norm())
        assert diff <= GRAD_RTOL * ref + 1e-6 * float(total), (name, diff, ref)
        ours.append(p.grad.flatten())
        theirs.append(ref_grads[name].flatten())
    assert _rel_l2(torch.cat(ours), torch.cat(theirs)) <= TOTAL_GRAD_RTOL
    # The classifier's gradient is well conditioned: f32 rounding only.
    assert _rel_l2(model.out_conv1x1.weight.grad, ref_grads["out_conv1x1.weight"]) <= 1e-4


def _configure(c, data_dir, lr: float):
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = 2
    c.datamodule.random_crop_size = 64
    c.train.compute_dtype = "float32"
    c.train.num_devices = 1
    c.train.loss_type = c.train.loss_type.__class__("focal")
    c.train.weighted_loss = True
    c.train.class_distribution = list(DIST)
    c.train.lr = lr
    c.train.watch_interval = 0
    return c


def test_two_trainer_steps_track_the_jax_trainer(fixture_dir, monkeypatch):
    """Same init (JAX weights converted), same batch, drop-connect keeping
    everything on both sides; Adam + L2 at lr 1e-4. Step 1's loss agrees to
    f32 rounding. Step 2's follows one update that moves the loss by several
    percent; Adam's first step normalizes each gradient element, so the
    gradient noise of the module docstring reaches the weights, and step 2's
    loss agrees to 1e-3 (lr 1e-4 keeps that noise well inside it)."""
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.ones(shape, bool))
    monkeypatch.setattr(tu, "drop_connect_mask", lambda batch, keep, generator, device: torch.ones(batch, 1, 1, 1, dtype=torch.bool))
    jcfg = _configure(jax_cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass"), fixture_dir, 1e-4)
    pcfg = _configure(cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass"), fixture_dir, 1e-4)
    jdm = JaxDatamodule(jcfg.datamodule, process_count=1, process_index=0)
    dm = Datamodule(pcfg.datamodule)
    dm.set_mean_std(*jdm.mean_std())
    jtrainer = JaxTrainer(jcfg, jdm)
    trainer = SegmentationTrainer(pcfg, dm, device="cpu")
    trainer.model.load_state_dict(
        unet_state_dict_from_jax(jax.device_get(jtrainer.state.params), jax.device_get(jtrainer.state.batch_stats)),
        strict=True,
    )
    batch = next(dm.train_batches(0))
    jlosses, ours = [], []
    state = jtrainer.state
    for _ in range(2):
        state, m = jtrainer.train_step(state, jnp.asarray(batch.images), jnp.asarray(batch.labels), jtrainer.base_rng)
        jlosses.append(float(m["loss"]))
        ours.append(float(trainer.train_step(torch.from_numpy(batch.images), torch.from_numpy(batch.labels))["loss"]))
    assert trainer.step == 2
    np.testing.assert_allclose(ours[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(ours[1], jlosses[1], rtol=1e-3)
    assert abs(ours[1] - ours[0]) > 1e-2 * ours[0]  # the update moved the model


def test_cli_trains_checkpoints_resumes_and_serves(fixture_dir, tmp_path, monkeypatch):
    from s2tpu.geo.tiff import read_geotiff
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.cli.train_segmentation import main as train_main
    from s2tpu_torch.configs import paths

    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    argv = [
        "small", "osm-multiclass", "efficientnet-unet-b0", "--loss-type", "focal", "--weighted-loss",
        "--bs", "2", "--crop", "64", "--compute-dtype", "float32", "--data-dir", str(fixture_dir),
        "--name", "cpu", "--log-interval", "1", "--device", "cpu",
    ]
    history = train_main(argv + ["--epochs", "2"])
    assert [r["epoch"] for r in history] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["val/loss"]) for r in history)
    (run_dir,) = (tmp_path / "ckpts").glob("*/cpu_*")
    assert io.epochs_in(run_dir)[-1] == 1
    steps = [line for line in (tmp_path / "logs" / "runs" / f"{run_dir.name}.metrics.jsonl").read_text().splitlines()
             if "train/loss_step" in line]
    assert len(steps) == 4  # 4 train segments / batch 2 = 2 steps per epoch

    config, state = io.load_checkpoint(run_dir)
    assert config.train.loss_type.value == "focal" and all(v.dtype == torch.float32 for v in state.values()
                                                          if v.is_floating_point())
    out = infer_main([str(run_dir), "--tiled", "--device", "cpu", "--out", str(tmp_path / "preds"),
                      "--data-dir", str(fixture_dir)])
    preds = sorted(out.glob("pred_*.tif"))
    assert len(preds) == 1  # one val segment of six
    data, _ = read_geotiff(preds[0])
    assert data.shape == (1, 96, 96) and data.max() < 4

    resumed = train_main(argv + ["--epochs", "3", "--resume-from", str(run_dir)])
    assert [r["epoch"] for r in resumed] == [2]
    assert io.CheckpointManager(run_dir).restore(2)["step"] == 6  # the step count carried over


def test_cli_config_matches_the_jax_cli(tmp_path):
    """The flags both CLIs take build the same config tree (the run name's
    random part aside)."""
    import dataclasses

    from s2tpu.cli.train_segmentation import build_parser as jax_parser
    from s2tpu.cli.train_segmentation import config_from_args as jax_config_from_args
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args

    argv = [
        "fr", "osm-multiclass", "efficientnet-unet-b5", "--type", "overfit", "--loss-type", "dice_focal",
        "--lr-scheduler", "cosine", "--bs", "16", "--lr", "3e-4", "--scale-lr-ref-bs", "32", "--epochs", "7",
        "--log-interval", "5", "--focal-loss-gamma", "1.5", "--weighted-loss", "--cosine-lr-sched-first-cycle-steps",
        "4", "--cosine-lr-sched-cycle-mult", "2", "--cosine-lr-sched-max-lr", "1e-3", "--cosine-lr-sched-min-lr",
        "1e-6", "--cosine-lr-sched-warmup-steps", "1", "--cosine-lr-sched-gamma", "0.5", "--name", "x", "--wandb",
        "--tags", "a", "b", "--compute-dtype", "float32", "--bands", "all12", "--crop", "128", "--data-dir",
        str(tmp_path), "--seed", "7", "--auto-resume", "--remat", "--param-dtype", "bfloat16", "--ema-decay",
        "0.99", "--watch-interval", "5", "--bn-recal", "3", "--device-corpus", "--steps-per-dispatch", "4",
    ]
    theirs = dataclasses.asdict(jax_config_from_args(jax_parser().parse_args(argv)))
    ours = dataclasses.asdict(config_from_args(build_parser().parse_args(argv)))
    assert ours == theirs


def test_cli_without_cuda_raises_unless_cpu_is_asked(monkeypatch, fixture_dir):
    from s2tpu_torch.cli.train_segmentation import main as train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["small", "osm-multiclass", "efficientnet-unet-b0", "--data-dir", str(fixture_dir)])


@pytest.mark.parametrize("flags", [["--type", "tune", "--num-devices", "2"]])
def test_cli_refuses_unported_flags(flags):
    """The CLI refuses, before any rank starts, the flags of what the port
    lacks: tune trials over a data axis (each trial runs in one process).
    The sharded corpus, refused here until it was ported, is taken
    (``test_cli_takes_ported_flags``)."""
    from s2tpu_torch.cli.train_segmentation import main

    with pytest.raises(SystemExit, match="one process"):
        main(["small", "osm-multiclass", "efficientnet-unet-b0", "--device", "cpu", *flags])


@pytest.mark.parametrize(
    "flags,fields",
    [(["--remat", "--ema-decay", "0.99"], {"remat": True, "ema_decay": 0.99}),
     (["--device-corpus", "--steps-per-dispatch", "4"], {"device_corpus": True, "steps_per_dispatch": 4}),
     (["--num-devices", "4"], {"num_devices": 4}),
     (["--fsdp", "--num-devices", "2"], {"num_devices": 2}),
     (["--device-corpus-sharded", "--num-devices", "2"],
      {"device_corpus": True, "device_corpus_sharded": True, "num_devices": 2})],
)
def test_cli_takes_ported_flags(flags, fields):
    """The flags of features once refused here (the trainer extras, the
    device corpus and its windows, the data axis, ``--fsdp``, which shards
    nothing on the CLI's model axis of one rank, and the sharded corpus,
    which implies the corpus) reach the config."""
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args

    t = config_from_args(build_parser().parse_args(["small", "osm-multiclass", "efficientnet-unet-b0", *flags])).train
    assert {k: getattr(t, k) for k in fields} == fields


def test_cli_takes_type_tune_and_source():
    """``--type tune`` and its knobs, once refused here, and ``--source``
    parse as the JAX CLI parses them, into the JAX CLI's config."""
    from s2tpu.cli.train_segmentation import build_parser as jax_parser
    from s2tpu.cli.train_segmentation import config_from_args as jax_config_from_args
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args

    argv = ["small", "osm-multiclass", "efficientnet-unet-b0", "--type", "tune", "--n-trials", "3",
            "--epochs-per-trial", "2", "--tune-crops", "64,128", "--tune-batch-sizes", "8,16", "--tune-eta", "3",
            "--source", "records", "--name", "t"]
    ours, theirs = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    for flag in ("type", "n_trials", "epochs_per_trial", "tune_crops", "tune_batch_sizes", "tune_eta", "source"):
        assert getattr(ours, flag) == getattr(theirs, flag), flag
    config, jax_config = config_from_args(ours), jax_config_from_args(theirs)
    assert config.train.tags == jax_config.train.tags == ["tune"]
    assert config.train.use_wandb_logger is jax_config.train.use_wandb_logger is False


class _Mesh:
    """The shape of a DeviceMesh, for refusals that read only its axes."""

    def __init__(self, data: int, model: int) -> None:
        self.mesh_dim_names, self.shape = ("data", "model"), (data, model)


# Once refused here: a model axis above one rank (FSDP, tests/test_torch_fsdp.py
# trains it on 1 x 2 and 2 x 2 meshes) and the sharded corpus, which on one
# process is the plain corpus, as in the JAX trainer (tests/test_torch_sharded_corpus.py
# holds it on a data axis). What the "mesh" case holds now: the FSDP rule
# shards B0's large tensors over a model axis of the mesh's size, and a
# param_sharding the JAX trainer lacks is refused.
@pytest.mark.parametrize("field,value", [("device_corpus_sharded", True), ("mesh", _Mesh(1, 2))])
def test_trainer_refuses_unported_config_fields(field, value, fixture_dir):
    from s2tpu_torch.parallel.mesh import fsdp_shard_dim

    c = _configure(cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass"),
                   fixture_dir, 1e-3)
    if field == "device_corpus_sharded":
        c.train.device_corpus = c.train.device_corpus_sharded = True
        trainer = SegmentationTrainer(c, Datamodule(c.datamodule), device="cpu")
        assert not trainer.corpus.sharded and trainer.corpus.images.shape[0] == len(trainer.dm.source)
        return
    m = value.shape[1]
    model = c.build_model(device="cpu")
    modules = dict(model.named_modules())
    dims = {n: fsdp_shard_dim(modules[n.rpartition(".")[0]], p, m) for n, p in model.named_parameters()}
    sharded = {n for n, d in dims.items() if d is not None}
    assert sharded and all(model.get_parameter(n).numel() >= 2**16 for n in sharded)
    assert all(model.get_parameter(n).shape[dims[n]] % m == 0 for n in sharded)
    with pytest.raises(ValueError, match="param_sharding='zero3'"):
        SegmentationTrainer(c, datamodule=None, device="cpu", mesh=value, param_sharding="zero3")


# The fields refused until they were ported train now: each case holds its
# feature at work (one step; the corpus cases one epoch from the corpus).
PORTED_FIELDS = [("grad_accum_steps", 2), ("remat", True), ("ema_decay", 0.99), ("param_dtype", "bfloat16"),
                 ("bn_recalibration_batches", 4), ("device_corpus", True), ("steps_per_dispatch", 2),
                 ("num_devices", -1), ("num_devices", 1)]


@pytest.mark.parametrize("field,value", PORTED_FIELDS)
def test_trainer_trains_ported_config_fields(field, value, fixture_dir):
    c = _configure(cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass"),
                   fixture_dir, 1e-3)
    setattr(c.train, field, value)
    if field == "steps_per_dispatch":
        c.train.device_corpus = True
    trainer = SegmentationTrainer(c, Datamodule(c.datamodule), device="cpu")
    if c.train.device_corpus:
        m = trainer.run_train_epoch(0)  # 4 train segments: 2 steps from the corpus
        assert trainer.corpus is not None and trainer.device_flips and trainer.step == 2
    else:
        batch = next(trainer.dm.train_batches(0))
        m = trainer.train_step(torch.from_numpy(batch.images), torch.from_numpy(batch.labels))
        assert trainer.step == 1
    assert np.isfinite(float(m["loss"]))
    if field == "remat":
        assert trainer.model.remat
    if field == "ema_decay":
        assert trainer.ema is not None and trainer.ema.decay == value
    if field == "param_dtype":
        assert {p.dtype for p in trainer.model.parameters()} == {torch.bfloat16}
        assert trainer.master.master["out_conv1x1.weight"].dtype == torch.float32
    if field == "bn_recalibration_batches":
        before = trainer.model.encoder.stem[1].running_var.clone()
        trainer.recalibrate_bn(value)
        assert not torch.equal(before, trainer.model.encoder.stem[1].running_var)


def test_checkpoint_manager_keeps_best_and_latest(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters())
    ckpt = io.CheckpointManager(tmp_path / "run", keep=1, monitor="val/loss", mode="min")
    for epoch, val_loss in enumerate([0.5, 0.3, 0.4, 0.6]):
        ckpt.save_epoch(epoch, model, opt, step=10 * (epoch + 1), metrics={"val/loss": val_loss})
    assert io.epochs_in(tmp_path / "run") == [1, 3]  # best (0.3) and latest
    assert ckpt.latest_epoch() == 3
    assert ckpt.restore(3)["step"] == 40
    with pytest.raises(FileNotFoundError):
        ckpt.restore(0)
