"""fc-prithvi (Prithvi-100M segmentation) in s2tpu_torch against the JAX package, on the CPU in f32.

Flax parameters (with random BatchNorm statistics) go into the port through
``prithvi_seg_state_dict_from_jax``. Widths are tiny (embed 64, 4 heads,
depth 1-2, an FCN head of 16); four geometries reach each of the port's
attention routes: plain attention (patch 16, T = 1 and T = 2), the fused
route whose plain version stands in for kernel #8 on the CPU (patch 8,
L = 145) and the streaming route of kernel #5 (patch 2, L = 1025 > the fused
route's longest). The JAX model runs its default plain attention, the
attention the port's kernels compute.

Tolerances: both sides compute in f32 and sum in other orders through one or
two transformer blocks, four transpose convs and the head. Logits agree to
TOL_LOGITS of their scale (measured: at most 1.1e-6), running statistics to
TOL_STATS relative (measured: 6e-8) and each parameter gradient to GRAD_RTOL
in relative L2 (measured: at most 1.5e-5). The head's train-mode BatchNorm
runs over 2 x 32² values per channel here, which keeps it well conditioned;
the bias of the conv before it has a zero gradient up to rounding, hence a
floor relative to all gradients, as in test_torch_train.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.checkpoint.convert_torch import export_reference_prithvi_seg_state_dict
from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.data.pipeline import Datamodule as JaxDatamodule
from s2tpu.models import prithvi_mae as jm
from s2tpu.models.prithvi_seg import PrithviSegmentationConfig as JaxSegConfig
from s2tpu.models.prithvi_seg import PrithviSegmentationNet as JaxSegNet
from s2tpu.train import losses as jax_losses
from s2tpu.train.trainer import SegmentationTrainer as JaxTrainer
from s2tpu_torch.checkpoint import io
from s2tpu_torch.checkpoint.convert import prithvi_seg_state_dict_from_jax
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.data.pipeline import Datamodule
from s2tpu_torch.models import prithvi_mae as tm
from s2tpu_torch.models import prithvi_seg as ts
from s2tpu_torch.ops import flash_attention as fa
from s2tpu_torch.train import losses
from s2tpu_torch.train.trainer import SegmentationTrainer

TOL_LOGITS = 1e-4
TOL_STATS = 1e-5
GRAD_RTOL = 1e-4
K = 4
EMBED, HEADS, FCN = 64, 4, 16
# name: (crop, patch, frames, depth, batch, the port's encoder route)
GEOMETRIES = {
    "t1": (32, 16, 1, 2, 2, "plain"),
    "t2": (32, 16, 2, 2, 2, "plain"),
    "fused": (96, 8, 1, 1, 2, "fused"),
    "flash": (64, 2, 1, 1, 1, "flash"),
}


def _configs(name: str, frozen: bool = True, dropout: float = 0.0):
    crop, patch, frames, depth, _, _ = GEOMETRIES[name]
    widths = dict(img_size=crop, patch_size=patch, num_frames=frames, in_chans=6, embed_dim=EMBED, depth=depth,
                  num_heads=HEADS, decoder_embed_dim=48, decoder_depth=1, decoder_num_heads=4)
    seg = dict(num_frames=frames, num_classes=K, fcn_out_channels=FCN, fcn_num_convs=1, fcn_dropout=dropout,
               frozen_backbone=frozen, embed_dim=EMBED, patch_height=crop // patch, patch_width=crop // patch)
    jcfg = JaxSegConfig(**seg, backbone=jm.PrithviConfig(**widths))
    tcfg = ts.PrithviSegmentationConfig(**seg, backbone=tm.PrithviConfig(**widths, attention_impl="fused"))
    return jcfg, tcfg


def _random_stats(stats, rng):
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, np.shape(v)) if path[-1].key == "var"
                         else 0.1 * rng.normal(size=np.shape(v))).astype(np.float32),
        jax.device_get(stats),
    )


def _case(name: str, frozen: bool = True, seed: int = 0):
    """(JAX config, port config, params, batch stats, input (B, T, H, W, C))."""
    jcfg, tcfg = _configs(name, frozen)
    crop, _, frames, _, batch, _ = GEOMETRIES[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, frames, crop, crop, 6)).astype(np.float32)
    variables = jax.jit(lambda: JaxSegNet(jcfg).init(jax.random.key(seed), jnp.zeros((1, frames, crop, crop, 6))))()
    return jcfg, tcfg, jax.device_get(variables["params"]), _random_stats(variables["batch_stats"], rng), x


def _port(tcfg, params, stats) -> ts.PrithviSegmentationNet:
    model = ts.PrithviSegmentationNet(tcfg)
    model.load_state_dict(prithvi_seg_state_dict_from_jax(params, stats, tcfg.backbone), strict=True)
    return model


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def t2_case():
    return _case("t2")


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_eval_forward_matches_flax(name):
    jcfg, tcfg, params, stats, x = _case(name)
    crop, patch, frames, _, _, route = GEOMETRIES[name]
    l = frames * (crop // patch) ** 2 + 1
    assert fa.attention_route(l, EMBED, HEADS, "fused") == route
    apply = jax.jit(lambda p, s, x: JaxSegNet(jcfg).apply({"params": p, "batch_stats": s}, x))
    want = np.asarray(apply(params, stats, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(tcfg, params, stats)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (x.shape[0], 16 * crop // patch, 16 * crop // patch, K)
    assert np.abs(got - want).max() <= TOL_LOGITS * max(1.0, np.abs(want).max())


def test_state_dict_export_equals_s2tpu(t2_case):
    """Key for key and value for value, the transpose-conv flip included; the
    port's module loads the result with strict=True."""
    _, tcfg, params, stats, _ = t2_case
    jbackbone = jm.PrithviConfig(**{f.name: getattr(tcfg.backbone, f.name) for f in dataclasses.fields(jm.PrithviConfig)
                                    if hasattr(tcfg.backbone, f.name) and f.name != "attention_impl"})
    want = export_reference_prithvi_seg_state_dict(params, stats, jbackbone)
    got = prithvi_seg_state_dict_from_jax(params, stats, tcfg.backbone)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == torch.from_numpy(np.asarray(value)).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    model = ts.PrithviSegmentationNet(tcfg)
    model.load_state_dict(got, strict=True)
    # The flip matters: the up-convs' 2x2 kernels are not symmetric.
    w = got["neck.feature_pyramid_net.0.weight"]
    assert not torch.equal(w, w.flip(-1, -2))
    assert not any(k.startswith("backbone.decoder") for k in model.state_dict())


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
def test_train_mode_matches_flax(frozen):
    """Dropout 0: logits, loss, the head's BatchNorm running statistics and
    every gradient; the frozen backbone has none (JAX: zero)."""
    jcfg, tcfg, params, stats, x = _case("t1", frozen=frozen, seed=1)
    labels = np.random.default_rng(2).integers(0, K, size=(x.shape[0], 32, 32)).astype(np.int32)
    jloss_fn = jax_losses.make_loss_fn("ce", K, masked_loss=True)

    def loss_fn(p):
        logits, mutated = JaxSegNet(jcfg).apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(x), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0)},
        )
        return jloss_fn(logits, jnp.asarray(labels)).total, (logits, mutated["batch_stats"])

    (jloss, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = _port(tcfg, params, stats)
    model.train()
    logits = model(torch.from_numpy(x), generator=torch.Generator())
    loss = losses.make_loss_fn("ce", K, masked_loss=True)(logits, torch.from_numpy(labels)).total
    loss.backward()

    assert np.abs(logits.detach().numpy() - np.asarray(jlogits)).max() <= TOL_LOGITS * max(
        1.0, float(np.abs(np.asarray(jlogits)).max()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref_state = prithvi_seg_state_dict_from_jax(params, jax.device_get(jstats), tcfg.backbone)
    for name, buf in model.named_buffers():
        if "running" in name:
            err = (buf - ref_state[name]).abs() / ref_state[name].abs().clamp_min(1.0)
            assert float(err.max()) <= TOL_STATS, name
    ref_grads = prithvi_seg_state_dict_from_jax(jax.device_get(jgrads), stats, tcfg.backbone)
    named = dict(model.named_parameters())
    total = float(torch.cat([g.flatten() for n, g in ref_grads.items() if n in named]).norm())
    for name, p in model.named_parameters():
        if name.startswith("backbone.") and frozen:
            assert p.grad is None and not p.requires_grad, name
            assert float(ref_grads[name].abs().max()) == 0.0, name
            continue
        assert p.grad is not None, name
        # The head conv's bias, which a train-mode BatchNorm follows, has a
        # zero gradient up to rounding: hence the floor relative to all.
        diff, ref = float((p.grad - ref_grads[name]).norm()), float(ref_grads[name].norm())
        assert diff <= GRAD_RTOL * ref + 1e-6 * total, (name, diff, ref)


def test_frozen_backbone_builds_no_graph():
    _, tcfg, params, stats, x = _case("t1")
    model = _port(tcfg, params, stats).train()
    tokens = []
    model.backbone.norm.register_forward_hook(lambda m, i, o: tokens.append(o))
    model(torch.from_numpy(x), generator=torch.Generator())
    assert tokens[0].grad_fn is None and not tokens[0].requires_grad


# ---------------------------------------------------------------- trainer ----
TINY = dict(in_chans=6, embed_dim=EMBED, depth=1, num_heads=HEADS, decoder_embed_dim=48, decoder_depth=1,
            decoder_num_heads=4)


def _tiny_seg(config, dropout: float, module):
    """``module``'s fc-prithvi config of ``config`` at tiny widths (patch 16,
    the JAX build_model's geometry rules)."""
    crop = config.datamodule.random_crop_size
    t = config.datamodule.dataset_cfg.n_time_frames
    backbone = dict(TINY, img_size=crop, patch_size=16, num_frames=t)
    if module is ts:
        backbone["attention_impl"] = "fused"
    bcfg = (tm if module is ts else jm).PrithviConfig(**backbone)
    cls = ts.PrithviSegmentationConfig if module is ts else JaxSegConfig
    return cls(num_frames=t, num_classes=config.num_classes, fcn_out_channels=FCN, fcn_num_convs=1,
               fcn_dropout=dropout, frozen_backbone=config.train.frozen_backbone, embed_dim=EMBED,
               patch_height=crop // 16, patch_width=crop // 16, backbone=bcfg)


def _tiny_port(monkeypatch, dropout: float = 0.0) -> None:
    monkeypatch.setattr(cfg_lib, "fc_prithvi_config", lambda config: _tiny_seg(config, dropout, ts))


def _configure(c, data_dir, **train):
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = 2
    c.datamodule.random_crop_size = 64
    c.train.compute_dtype = "float32"
    c.train.num_devices = 1
    c.train.watch_interval = 0
    c.train.class_distribution = [0.1, 0.3, 0.4, 0.2]
    for k, v in train.items():
        setattr(c.train, k, v)
    return c


def _port_trainer(fixture_dir, ckpt=None, **train) -> SegmentationTrainer:
    cfg = _configure(cfg_lib.base_config("fc-prithvi-backbone", aoi="small", label_map="osm-multiclass"),
                     fixture_dir, **train)
    return SegmentationTrainer(cfg, Datamodule(cfg.datamodule), checkpoint_manager=ckpt, device="cpu")


def _backbone(trainer) -> dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in trainer.model.backbone.state_dict().items()}


def _equal(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_two_frozen_steps_track_the_jax_trainer(fixture_dir, monkeypatch):
    """Same init (JAX weights converted), same batch, dropout 0, Adam + L2 at
    lr 1e-4 over the head only: step 1's loss to f32 rounding, step 2's to
    1e-5 relative, the head's parameters to 1e-4 relative L2 after the two
    updates; the backbone unchanged bit for bit."""
    _tiny_port(monkeypatch)
    monkeypatch.setattr(jax_cfg_lib.Config, "build_model", lambda self: JaxSegNet(_tiny_seg(self, 0.0, None)))
    jcfg = _configure(jax_cfg_lib.base_config("fc-prithvi-backbone", aoi="small", label_map="osm-multiclass"),
                      fixture_dir, lr=1e-4)
    jdm = JaxDatamodule(jcfg.datamodule, process_count=1, process_index=0)
    jtrainer = JaxTrainer(jcfg, jdm)
    trainer = _port_trainer(fixture_dir, lr=1e-4)
    trainer.dm.set_mean_std(*jdm.mean_std())
    trainer.mean, trainer.std = (torch.as_tensor(np.asarray(v, np.float32)) for v in jdm.mean_std())
    bcfg = trainer.model.config.backbone
    state = jax.device_get(jtrainer.state)
    trainer.model.load_state_dict(prithvi_seg_state_dict_from_jax(state.params, state.batch_stats, bcfg), strict=True)
    n_head = sum(1 for n, _ in trainer.model.named_parameters() if not n.startswith("backbone."))
    assert sum(len(g["params"]) for g in trainer.optimizer.param_groups) == n_head
    before = _backbone(trainer)
    batch = next(trainer.dm.train_batches(0))
    jstate, jlosses, ours = jtrainer.state, [], []
    for _ in range(2):
        jstate, m = jtrainer.train_step(jstate, jnp.asarray(batch.images), jnp.asarray(batch.labels), jtrainer.base_rng)
        jlosses.append(float(m["loss"]))
        ours.append(float(trainer.train_step(torch.from_numpy(batch.images), torch.from_numpy(batch.labels))["loss"]))
    np.testing.assert_allclose(ours[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(ours[1], jlosses[1], rtol=1e-5)
    assert abs(ours[1] - ours[0]) > 1e-3 * ours[0]  # the update moved the head
    assert _equal(_backbone(trainer), before)
    want = prithvi_seg_state_dict_from_jax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats), bcfg)
    for name, p in trainer.model.named_parameters():
        if name == "head.net.0.bias":
            # Its gradient is zero up to rounding (a train-mode BatchNorm
            # follows), which Adam's first steps scale to about +-lr each.
            assert float((p.detach() - want[name]).abs().max()) <= 4 * 1e-4
        elif not name.startswith("backbone."):
            assert _rel_l2(p.detach().numpy(), want[name].numpy()) <= GRAD_RTOL, name


def test_unfreeze_mid_fit(fixture_dir, monkeypatch):
    """Frozen through epoch 0, then one fresh Adam over every parameter at
    the scaled schedule; the step count carries on."""
    _tiny_port(monkeypatch, dropout=0.1)
    trainer = _port_trainer(fixture_dir, lr=1e-3, unfreeze_backbone_at_epoch=1, unfreeze_lr_scale=0.1)
    init = _backbone(trainer)
    history = trainer.fit(epochs=1)
    assert _equal(_backbone(trainer), init) and trainer.model.frozen_backbone
    assert trainer.step == 2 and history[0]["train/lr"] == pytest.approx(1e-3)
    head_opt = trainer.optimizer

    trainer._maybe_unfreeze(1)
    assert trainer.optimizer is not head_opt and not trainer.model.frozen_backbone
    assert not trainer.config.train.frozen_backbone
    n_all = sum(1 for _ in trainer.model.parameters())
    assert sum(len(g["params"]) for g in trainer.optimizer.param_groups) == n_all
    assert len(trainer.optimizer.state) == 0  # fresh moments
    assert trainer.schedule(trainer.step) == pytest.approx(1e-4)
    trainer._maybe_unfreeze(1)  # once only
    assert trainer.schedule(trainer.step) == pytest.approx(1e-4)

    history += trainer.fit(epochs=2, start_epoch=1)
    assert not _equal(_backbone(trainer), init)
    assert trainer.step == 4 and history[1]["train/lr"] == pytest.approx(1e-4)
    assert all(np.isfinite(h["train/loss"]) for h in history)


@pytest.mark.parametrize("resume_epoch", [0, 1], ids=["before_transition", "after_transition"])
def test_resume_across_the_transition(fixture_dir, tmp_path, monkeypatch, resume_epoch):
    """A checkpoint from before the transition resumes frozen and unfreezes on
    entering epoch 1; one from after it unfreezes before its optimizer (of
    every parameter) loads. Either way the run ends where an unbroken one
    does."""
    _tiny_port(monkeypatch)
    train = dict(lr=1e-3, unfreeze_backbone_at_epoch=1)
    ckpt = io.CheckpointManager(tmp_path / "run", keep=3)
    whole = _port_trainer(fixture_dir, ckpt, **train)
    whole.fit(epochs=2)
    assert io.epochs_in(tmp_path / "run") == [0, 1]
    last = {k: v.clone() for k, v in whole.model.state_dict().items()}

    resumed = _port_trainer(fixture_dir, io.CheckpointManager(tmp_path / "run", keep=3), **train)
    start = resumed.resume_from_checkpoint(resume_epoch)
    assert start == resume_epoch + 1 and resumed.step == 2 * start
    assert resumed.model.frozen_backbone == (resume_epoch == 0)
    if resume_epoch == 0:
        resumed.fit(epochs=2, start_epoch=start)
    state = resumed.model.state_dict()
    for k, v in last.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


# -------------------------------------------------------------------- CLI ----
def test_cli_flags_parse_to_the_jax_config(tmp_path):
    from s2tpu.cli.train_segmentation import build_parser as jax_parser
    from s2tpu.cli.train_segmentation import config_from_args as jax_config_from_args
    from s2tpu_torch.cli.train_segmentation import build_parser, config_from_args

    base = ["fr", "osm-multiclass", "fc-prithvi-backbone", "--bs", "8", "--crop", "224", "--name", "x",
            "--auto-resume", "--data-dir", str(tmp_path)]
    for extra in (["--backbone-ckpt", "/m", "--unfreeze-at-epoch", "3", "--unfreeze-lr-scale", "0.1",
                   "--time-frames", "3"], ["--unfreeze-backbone"], []):
        theirs = dataclasses.asdict(jax_config_from_args(jax_parser().parse_args(base + extra)))
        ours = dataclasses.asdict(config_from_args(build_parser().parse_args(base + extra)))
        assert ours == theirs, extra
    c = config_from_args(build_parser().parse_args(base + ["--unfreeze-at-epoch", "3"]))
    assert c.train.frozen_backbone and c.train.unfreeze_backbone_at_epoch == 3
    assert not c.datamodule.dataset_cfg.squeeze_time_dim


def _mae_run(run_dir, tcfg_backbone, seed: int = 5):
    """A port MAE run directory (epoch 0) of a seeded MAE at the seg
    backbone's geometry; returns the MAE's state dict."""
    from s2tpu_torch.configs import mae as mae_cfg

    mae = tm.PrithviMAE(dataclasses.replace(tcfg_backbone, attention_impl="fused"),
                        generator=torch.Generator().manual_seed(seed))
    ckpt = io.CheckpointManager(run_dir, config_dict=dataclasses.asdict(mae_cfg.base_config("small")))
    ckpt.save_epoch(0, mae, torch.optim.Adam(mae.parameters()), 0)
    return mae.state_dict()


def test_backbone_ckpt_loads_the_encoder_of_a_port_mae_run(fixture_dir, tmp_path, monkeypatch):
    _tiny_port(monkeypatch)
    probe = _port_trainer(fixture_dir)
    mae_state = _mae_run(tmp_path / "mae", probe.model.config.backbone)
    trainer = _port_trainer(fixture_dir, backbone_ckpt=str(tmp_path / "mae"))
    got = trainer.model.backbone.state_dict()
    assert set(got) == {k for k in mae_state if not (k.startswith("decoder") or k == "mask_token")}
    assert all(torch.equal(got[k], mae_state[k]) for k in got)
    assert not _equal(got, probe.model.backbone.state_dict())


def test_published_layout_loads_encoder_only_or_warns(fixture_dir, tmp_path, monkeypatch, caplog):
    """A synthetic Prithvi_100M.pt (decoder keys, position tables of the
    published three-frame grid) loads into the encoder; without the file the
    FROZEN warning is logged; a non-HLS band set skips the file."""
    from s2tpu_torch.configs import paths

    _tiny_port(monkeypatch)
    monkeypatch.setattr(paths, "WEIGHTS_DIR", tmp_path / "weights")
    with caplog.at_level(logging.WARNING):
        probe = _port_trainer(fixture_dir)
    assert "FROZEN" in caplog.text and "RANDOM encoder" in caplog.text

    published_cfg = dataclasses.replace(probe.model.config.backbone, num_frames=3)
    published = tm.PrithviMAE(published_cfg, generator=torch.Generator().manual_seed(9))
    sd = dict(published.state_dict())
    sd["pos_embed"], sd["decoder_pos_embed"] = published.pos_embed, published.decoder_pos_embed
    (tmp_path / "weights").mkdir()
    torch.save(sd, tmp_path / "weights" / "Prithvi_100M.pt")
    trainer = _port_trainer(fixture_dir)
    got = trainer.model.backbone.state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in got)

    caplog.clear()
    cfg = _configure(cfg_lib.base_config("fc-prithvi-backbone", aoi="small", label_map="osm-multiclass"), fixture_dir)
    cfg.datamodule.dataset_cfg.bands = ["B02", "B03", "B04", "B05", "B06", "B07"]  # six bands, not HLS's
    with caplog.at_level(logging.WARNING):
        skipped = SegmentationTrainer(cfg, Datamodule(cfg.datamodule), device="cpu")
    assert "cannot initialize this backbone" in caplog.text and "FROZEN" in caplog.text
    assert _equal(skipped.model.backbone.state_dict(), probe.model.backbone.state_dict())  # the seeded init


def test_cli_trains_across_the_unfreeze_resumes_and_serves(fixture_dir, tmp_path, monkeypatch):
    from s2tpu.geo.tiff import read_geotiff
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.cli.train_segmentation import main as train_main
    from s2tpu_torch.configs import paths

    _tiny_port(monkeypatch, dropout=0.1)
    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    tcfg = _tiny_seg(_configure(cfg_lib.base_config("fc-prithvi-backbone", "small", "osm-multiclass"),
                                fixture_dir), 0.1, ts)
    mae_state = _mae_run(tmp_path / "mae", tcfg.backbone)
    argv = ["small", "osm-multiclass", "fc-prithvi-backbone", "--bs", "2", "--crop", "64", "--compute-dtype",
            "float32", "--data-dir", str(fixture_dir), "--name", "p", "--log-interval", "1", "--device", "cpu",
            "--backbone-ckpt", str(tmp_path / "mae"), "--unfreeze-at-epoch", "1", "--unfreeze-lr-scale", "0.1"]
    encoder = [k for k in mae_state if not (k.startswith("decoder") or k == "mask_token")]
    n_params = len(dict(ts.PrithviSegmentationNet(tcfg).named_parameters()))
    history = train_main(argv + ["--epochs", "1"])  # epoch 0: frozen
    (run_dir,) = (tmp_path / "ckpts").glob("*/p_*")
    ckpt = io.CheckpointManager(run_dir)
    epoch0 = ckpt.restore(0)
    assert all(torch.equal(epoch0["model"][f"backbone.{k}"], mae_state[k]) for k in encoder)
    assert len(epoch0["optimizer"]["param_groups"][0]["params"]) == n_params - len(encoder)
    # Resumed from before the transition, into it.
    history += train_main(argv + ["--epochs", "2", "--resume-from", str(run_dir)])
    epoch1 = ckpt.restore(1)
    assert not any(torch.equal(epoch1["model"][f"backbone.{k}"], mae_state[k]) for k in ("cls_token", "norm.weight"))
    assert len(epoch1["optimizer"]["param_groups"][0]["params"]) == n_params
    # Resumed from after it.
    history += train_main(argv + ["--epochs", "3", "--resume-from", str(run_dir)])
    assert [r["epoch"] for r in history] == [0, 1, 2] and ckpt.restore(2)["step"] == 6
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["val/loss"]) for r in history)
    lrs = [r["train/lr"] for r in history]
    assert lrs[1] == pytest.approx(0.1 * lrs[0]) and lrs[2] == pytest.approx(lrs[1])

    out = infer_main([str(run_dir), "--tiled", "--device", "cpu", "--out", str(tmp_path / "preds"),
                      "--data-dir", str(fixture_dir)])
    (pred,) = sorted(out.glob("pred_*.tif"))
    data, _ = read_geotiff(pred)
    assert data.shape == (1, 96, 96) and data.max() < K
