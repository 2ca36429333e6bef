"""Checkpoint migration in s2tpu_torch (``cli.convert_weights``) against the JAX package, on the CPU.

Every conversion is a renaming or a transpose, so state dicts are held bit
for bit. Served logits of an imported checkpoint are held in f32: the UNet's
to LOGITS_ATOL (the two frameworks sum in other orders through ~40 conv
layers, as in ``tests/test_torch_unet.py``), fc-prithvi's to
SEG_LOGITS_RTOL of their scale (one transformer block, the neck and the
head, as in ``tests/test_torch_prithvi_seg.py``), and embeddings to
EMBED_RTOL of their scale (two transformer blocks). The real published
files (``Prithvi_100M.pt``, lukemelas ``efficientnet-b0.pth``, reference
Lightning runs) are not in the repository, so each conversion runs on a
synthetic state dict in the published layout, made from a seed. Prithvi
runs at tiny widths (embed 64, 4 heads, depth 1-2), as
``tests/test_convert_cli.py`` does.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import s2tpu.cli.convert_weights as jax_cw
from s2tpu.checkpoint import convert_torch as ct
from s2tpu.checkpoint.orbax_io import CheckpointManager as JaxCheckpointManager
from s2tpu.configs import mae as jax_mae_cfg
from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.infer.embed import make_embed_fn as jax_make_embed_fn
from s2tpu.models import prithvi_mae as jm
from s2tpu.models.efficientnet_unet import EfficientNetUNet as JaxUNet
from s2tpu.models.efficientnet_unet import EfficientNetUNetConfig as JaxUNetConfig
from s2tpu.models.prithvi_seg import PrithviSegmentationNet as JaxSegNet
from s2tpu.train.train_state import TrainState
from s2tpu_torch.checkpoint import convert, io
from s2tpu_torch.cli import convert_weights as cw
from s2tpu_torch.configs import mae as mae_cfg
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.infer.embed import load_encoder, make_embed_fn
from s2tpu_torch.models import efficientnet_unet as tu
from s2tpu_torch.models import prithvi_mae as tm
from s2tpu_torch.models import prithvi_seg as ts
from s2tpu_torch.models.prithvi_mae import sincos_3d
from tests.test_torch_prithvi_seg import _tiny_seg

LOGITS_ATOL = 1e-3
SEG_LOGITS_RTOL = 1e-4
EMBED_RTOL = 1e-4
K = 4  # osm-multiclass
TINY_MAE_ARGS = {
    "img_size": 32, "patch_size": 16, "num_frames": 1, "tubelet_size": 1, "in_chans": 6, "embed_dim": 64,
    "depth": 2, "num_heads": 4, "decoder_embed_dim": 48, "decoder_depth": 1, "decoder_num_heads": 4,
}
MEAN = np.full(6, 1000.0, np.float32)
STD = np.full(6, 500.0, np.float32)


def _tiny_args(num_frames=None):
    return {**TINY_MAE_ARGS, **({} if num_frames is None else {"num_frames": num_frames})}


def _random_stats(stats, rng):
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, np.shape(v)) if path[-1].key == "var"
                         else 0.1 * rng.normal(size=np.shape(v))).astype(np.float32),
        jax.device_get(stats),
    )


def _to_numpy(sd: dict) -> dict:
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in sd.items()}


def _assert_state_dicts_equal(ours: dict, theirs: dict) -> None:
    ours, theirs = _to_numpy(ours), _to_numpy(theirs)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype and ours[key].shape == value.shape, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def jax_b0():
    """A Flax B0 (6 bands, osm-multiclass's 4 classes) with random BatchNorm statistics."""
    cfg = JaxUNetConfig(version="b0", in_channels=6, num_classes=K)
    variables = jax.jit(lambda: JaxUNet(cfg).init(jax.random.key(0), jnp.zeros((1, 64, 64, 6)), train=False))()
    return cfg, jax.device_get(variables["params"]), _random_stats(variables["batch_stats"], np.random.default_rng(1))


@functools.cache
def _jax_unet_apply(cfg):
    return jax.jit(lambda v, x: JaxUNet(cfg).apply(v, x, train=False))


def _jax_unet_logits(cfg, params, stats, x) -> np.ndarray:
    return np.asarray(_jax_unet_apply(cfg)({"params": params, "batch_stats": stats}, jnp.asarray(x)))


def _port_logits(run_dir, x) -> np.ndarray:
    config, state = io.load_checkpoint(run_dir)
    model = config.build_model(dtype=torch.float32, device="cpu")
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


# ------------------------------------------------------------ lukemelas ----
def _lukemelas_b0(seed: int = 0) -> dict[str, torch.Tensor]:
    """A lukemelas EfficientNet-B0 (ImageNet layout: RGB stem, ``_fc``
    head, ``num_batches_tracked``) with seeded values."""
    g = torch.Generator().manual_seed(seed)
    sd: dict[str, torch.Tensor] = {}

    def bn(prefix: str, n: int) -> None:
        sd[f"{prefix}.weight"] = 1.0 + 0.1 * torch.randn(n, generator=g)
        sd[f"{prefix}.bias"] = 0.1 * torch.randn(n, generator=g)
        sd[f"{prefix}.running_mean"] = 0.1 * torch.randn(n, generator=g)
        sd[f"{prefix}.running_var"] = 0.5 + torch.rand(n, generator=g)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(7)

    sd["_conv_stem.weight"] = torch.randn(32, 3, 3, 3, generator=g)
    bn("_bn0", 32)
    specs = tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=2).block_specs
    for i, s in enumerate(specs):
        pre, mid = f"_blocks.{i}", s.in_filters * s.expand_ratio
        if s.expand_ratio != 1:
            sd[f"{pre}._expand_conv.weight"] = torch.randn(mid, s.in_filters, 1, 1, generator=g)
            bn(f"{pre}._bn0", mid)
        sd[f"{pre}._depthwise_conv.weight"] = torch.randn(mid, 1, s.kernel_size, s.kernel_size, generator=g)
        bn(f"{pre}._bn1", mid)
        sq = max(1, int(s.in_filters * s.se_ratio))
        sd[f"{pre}._se_reduce.weight"] = torch.randn(sq, mid, 1, 1, generator=g)
        sd[f"{pre}._se_reduce.bias"] = torch.randn(sq, generator=g)
        sd[f"{pre}._se_expand.weight"] = torch.randn(mid, sq, 1, 1, generator=g)
        sd[f"{pre}._se_expand.bias"] = torch.randn(mid, generator=g)
        sd[f"{pre}._project_conv.weight"] = torch.randn(s.out_filters, mid, 1, 1, generator=g)
        bn(f"{pre}._bn2", s.out_filters)
    sd["_conv_head.weight"] = torch.randn(1280, 320, 1, 1, generator=g)
    bn("_bn1", 1280)
    sd["_fc.weight"] = torch.randn(1000, 1280, generator=g)
    sd["_fc.bias"] = torch.randn(1000, generator=g)
    return sd


def test_lukemelas_map_equals_the_jax_mapping_then_the_ports(jax_b0):
    """lukemelas -> port directly == s2tpu's ``convert_efficientnet_state_dict``
    (merged over a Flax template, as ``load_efficientnet_weights`` does),
    then the port's ``unet_state_dict_from_jax``, bit for bit; the RGB stem
    and ``_fc`` are skipped."""
    sd = _lukemelas_b0()
    ours = convert.convert_efficientnet_state_dict(sd, in_channels=6)
    _, params, stats = jax_b0
    conv_p, conv_s = ct.convert_efficientnet_state_dict(sd, num_blocks=len({k.split(".")[1] for k in sd
                                                                            if k.startswith("_blocks.")}))
    merged_p = {**params, "encoder": ct._merge_into(params["encoder"], conv_p)}
    merged_s = {**stats, "encoder": ct._merge_into(stats["encoder"], conv_s)}
    theirs = convert.unet_state_dict_from_jax(merged_p, merged_s)
    encoder = {k for k in theirs if k.startswith("encoder.") and not k.endswith("num_batches_tracked")}
    assert set(ours) == encoder - {"encoder.stem.0.weight"}
    for key, value in ours.items():
        assert value.dtype == torch.float32
        assert torch.equal(value, theirs[key]), key
    assert not any("fc" in k.split(".")[-2] for k in ours)


def test_efficientnet_cli_writes_a_strict_loadable_unet(tmp_path):
    sd = _lukemelas_b0()
    torch.save(sd, tmp_path / "efficientnet-b0.pth")
    out = cw.main(["efficientnet", str(tmp_path / "efficientnet-b0.pth"), "--version", "b0",
                   "--out", str(tmp_path / "b0.pt")])
    state = torch.load(out, weights_only=True)
    model = tu.EfficientNetUNet(tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=2))
    model.load_state_dict(state, strict=True)
    init = tu.EfficientNetUNet(tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=2),
                               generator=torch.Generator().manual_seed(0)).state_dict()
    for key, value in convert.convert_efficientnet_state_dict(sd).items():
        assert torch.equal(state[key], value), key
    for key in ("encoder.stem.0.weight", "out_conv1x1.weight", "up_convs.0.weight"):  # seeded init
        assert torch.equal(state[key], init[key]), key


# ---------------------------------------------------------- import-ckpt ----
def _unet_ckpt(path, seed: int = 0) -> tuple[tu.EfficientNetUNet, dict]:
    """A seeded B0 saved as a reference Lightning checkpoint: ``net.``
    prefixes, the reference encoder's unused ``encoder.fc`` head, and a
    non-model entry."""
    g = torch.Generator().manual_seed(seed)
    model = tu.EfficientNetUNet(tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=K), generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=g))
    sd = {f"net.{k}": v for k, v in model.state_dict().items()}
    sd["net.encoder.fc.weight"], sd["net.encoder.fc.bias"] = torch.randn(1000, 1280, generator=g), torch.zeros(1000)
    sd["loss_fn.weight"] = torch.ones(K)
    torch.save({"state_dict": sd, "epoch": 9}, path)
    return model, sd


def _prithvi_seg_ckpt(path, config, seed: int = 0) -> dict:
    """A seeded tiny fc-prithvi saved as a reference Lightning checkpoint,
    its backbone's ``pos_embed`` included as the reference holds it."""
    g = torch.Generator().manual_seed(seed)
    seg = cfg_lib.fc_prithvi_config(config)
    model = ts.PrithviSegmentationNet(seg, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=g))
    sd = {f"net.{k}": v for k, v in model.state_dict().items()}
    sd["net.backbone.pos_embed"] = torch.from_numpy(
        sincos_3d(seg.backbone.embed_dim, seg.backbone.grid_size, cls_token=True)[None])
    torch.save({"state_dict": sd}, path)
    return sd


@pytest.mark.parametrize("model_name", ["efficientnet-unet-b0", "fc-prithvi-backbone"])
def test_import_ckpt_serves_jax_logits_and_resumes(model_name, fixture_dir, tmp_path, monkeypatch):
    """import-ckpt of a reference ``.ckpt``: the port run directory serves
    the logits of ``s2tpu``'s ``import_reference_checkpoint`` of the same
    file (f32), holds Adam as the trainer builds it (fc-prithvi's frozen
    backbone out of it), serves through ``cli.infer --tiled``, and
    ``--resume-from`` continues it for one epoch."""
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.cli.train_segmentation import main as train_main
    from s2tpu_torch.configs import paths

    prithvi = model_name.startswith("fc-prithvi")
    if prithvi:
        monkeypatch.setattr(cfg_lib, "fc_prithvi_config", lambda c: _tiny_seg(c, 0.0, ts))
        monkeypatch.setattr(jax_cfg_lib.Config, "build_model", lambda self: JaxSegNet(_tiny_seg(self, 0.0, None)))
    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    ckpt = tmp_path / "reference.ckpt"
    if prithvi:
        c = cfg_lib.base_config(model_name, aoi="small", label_map="osm-multiclass")
        c.datamodule.random_crop_size = 64
        _prithvi_seg_ckpt(ckpt, c)
    else:
        _unet_ckpt(ckpt)
    flags = ["--model", model_name, "--aoi", "small", "--labels", "osm-multiclass", "--crop", "64"]
    run_dir = cw.main(["import-ckpt", str(ckpt), *flags, "--out", str(tmp_path / "port_run")])
    jax_cw.main(["import-ckpt", str(ckpt), *flags, "--out", str(tmp_path / "jax_run")])

    assert io.epochs_in(run_dir) == [0]
    restored = io.CheckpointManager(run_dir).restore(0)
    config, _ = io.load_checkpoint(run_dir)
    model = config.build_model(dtype=torch.float32, device="cpu")
    trainable = [p for p in model.parameters() if p.requires_grad]
    assert restored["step"] == 0
    assert len(restored["optimizer"]["param_groups"][0]["params"]) == len(trainable)
    if prithvi:
        assert len(trainable) < len(list(model.parameters()))  # the frozen backbone stays out of Adam

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 1, 64, 64, 6) if prithvi else (2, 64, 64, 6)).astype(np.float32)
    from s2tpu.cli.infer import _config_from_dict

    mgr = JaxCheckpointManager(tmp_path / "jax_run")
    jconfig = _config_from_dict(mgr.load_config())
    raw = mgr.restore_raw(0)
    mgr.close()
    if prithvi:
        want = np.asarray(jax.jit(lambda v, x: jconfig.build_model().apply(v, x, train=False))(
            {"params": raw["params"], "batch_stats": raw["batch_stats"]}, jnp.asarray(x)))
    else:
        want = _jax_unet_logits(jconfig.build_model(dtype=jnp.float32).config, raw["params"], raw["batch_stats"], x)
    got = _port_logits(run_dir, x)
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    if prithvi:
        assert _rel(got, want) <= SEG_LOGITS_RTOL
    else:
        assert np.abs(got - want).max() <= LOGITS_ATOL

    out = infer_main([str(run_dir), "--tiled", "--device", "cpu", "--out", str(tmp_path / "preds"),
                      "--data-dir", str(fixture_dir)])
    assert len(list(out.glob("pred_*.tif"))) == 1  # one val segment of six

    argv = ["small", "osm-multiclass", model_name, "--bs", "2", "--crop", "64", "--compute-dtype", "float32",
            "--data-dir", str(fixture_dir), "--device", "cpu", "--epochs", "2", "--resume-from", str(run_dir)]
    history = train_main(argv)
    assert [r["epoch"] for r in history] == [1] and np.isfinite(history[0]["train/loss"])
    assert io.CheckpointManager(run_dir).restore(1)["step"] == 2  # 4 train segments at batch 2


# --------------------------------------------------------------- exports ----
def _save_port_run(run_dir, config_dict: dict, model: torch.nn.Module):
    ckpt = io.CheckpointManager(run_dir, config_dict=config_dict)
    ckpt.save_epoch(0, model, torch.optim.Adam([p for p in model.parameters() if p.requires_grad]), 0)
    return run_dir


def test_export_unet_equals_the_jax_export(jax_b0, tmp_path):
    cfg, params, stats = jax_b0
    model = tu.EfficientNetUNet(tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=K))
    model.load_state_dict(convert.unet_state_dict_from_jax(params, stats), strict=True)
    config = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    run = _save_port_run(tmp_path / "run", dataclasses.asdict(config), model)
    out = cw.main(["export-unet", str(run), "--out", str(tmp_path / "unet.pt")])
    exported = torch.load(out, weights_only=True)
    _assert_state_dicts_equal(exported, ct.export_reference_unet_state_dict(params, stats))
    fresh = tu.EfficientNetUNet(tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=K))
    fresh.load_state_dict(exported, strict=True)

    # A config with a parameter EMA: the port keeps none, so only --no-ema exports.
    config.train.ema_decay = 0.99
    ema_run = _save_port_run(tmp_path / "ema_run", dataclasses.asdict(config), model)
    with pytest.raises(NotImplementedError, match="15.4"):
        cw.main(["export-unet", str(ema_run), "--out", str(tmp_path / "ema.pt")])
    cw.main(["export-unet", str(ema_run), "--out", str(tmp_path / "ema.pt"), "--no-ema", "--epoch", "0"])
    _assert_state_dicts_equal(torch.load(tmp_path / "ema.pt", weights_only=True), exported)


def _jax_tiny_mae(seed: int = 0, num_frames: int = 1):
    jcfg = jm.PrithviConfig.from_model_args(_tiny_args(num_frames))
    sample = jnp.zeros((1, num_frames, 32, 32, 6))
    params = jax.jit(lambda: jm.PrithviMAE(jcfg).init(jax.random.key(seed), sample, mask_ratio=0.0))()["params"]
    return jcfg, jax.device_get(params)


def _port_mae_config(aoi: str = "small", num_frames: int = 1):
    config = mae_cfg.pretrain(mae_cfg.base_config(aoi))
    config.model.num_frames = config.datamodule.dataset_cfg.n_time_frames = num_frames
    config.datamodule.random_crop_size = 32
    return config


def test_export_prithvi_equals_the_jax_export(tmp_path, monkeypatch):
    monkeypatch.setattr(cw, "load_prithvi_model_args", _tiny_args)
    jcfg, params = _jax_tiny_mae(num_frames=2)
    tcfg = tm.PrithviConfig.from_model_args(_tiny_args(2))
    model = tm.PrithviMAE(tcfg)
    model.load_state_dict(convert.prithvi_state_dict_from_jax(params, tcfg), strict=True)
    run = _save_port_run(tmp_path / "mae", dataclasses.asdict(_port_mae_config(num_frames=2)), model)
    out = cw.main(["export-prithvi", str(run), "--out", str(tmp_path / "prithvi.pt")])
    exported = torch.load(out, weights_only=True)
    _assert_state_dicts_equal(exported, ct.export_prithvi_state_dict(params, jcfg))
    tm.PrithviMAE(tcfg).load_state_dict(exported, strict=True)  # tables equal the model's own


def test_export_prithvi_seg_equals_the_jax_export(tmp_path, monkeypatch):
    monkeypatch.setattr(cfg_lib, "fc_prithvi_config", lambda c: _tiny_seg(c, 0.0, ts))
    config = cfg_lib.base_config("fc-prithvi-backbone", aoi="small", label_map="osm-multiclass")
    config.datamodule.random_crop_size = 64
    jseg = _tiny_seg(config, 0.0, None)
    variables = jax.jit(lambda: JaxSegNet(jseg).init(jax.random.key(3), jnp.zeros((1, 1, 64, 64, 6))))()
    params = jax.device_get(variables["params"])
    stats = _random_stats(variables["batch_stats"], np.random.default_rng(4))
    tseg = cfg_lib.fc_prithvi_config(config)
    model = ts.PrithviSegmentationNet(tseg)
    model.load_state_dict(convert.prithvi_seg_state_dict_from_jax(params, stats, tseg.backbone), strict=True)
    run = _save_port_run(tmp_path / "seg", dataclasses.asdict(config), model)
    out = cw.main(["export-prithvi-seg", str(run), "--out", str(tmp_path / "seg.pt")])
    exported = torch.load(out, weights_only=True)
    _assert_state_dicts_equal(exported, ct.export_reference_prithvi_seg_state_dict(params, stats, jseg.backbone))
    ts.PrithviSegmentationNet(tseg).load_state_dict(exported, strict=True)


# ----------------------------------------------------------- round trips ----
def test_jax_unet_run_exports_into_a_port_run_with_the_same_logits(jax_b0, tmp_path):
    """An s2tpu UNet run -> s2tpu ``export-unet`` -> the port's
    ``import-ckpt``: the port serves the JAX run's logits."""
    from s2tpu.train.schedules import build_schedule
    from s2tpu.train.train_state import make_optimizer

    cfg, params, stats = jax_b0
    jconfig = jax_cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    t = jconfig.train
    opt_state = make_optimizer(build_schedule(t.lr, None), t.weight_decay, t.betas).init(params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=opt_state)
    mgr = JaxCheckpointManager(tmp_path / "jax_run", config_dict=dataclasses.asdict(jconfig))
    mgr.save_epoch(0, state)
    mgr.wait()
    mgr.close()
    jax_cw.main(["export-unet", str(tmp_path / "jax_run"), "--out", str(tmp_path / "unet.pt")])
    run_dir = cw.main(["import-ckpt", str(tmp_path / "unet.pt"), "--model", "efficientnet-unet-b0", "--aoi", "small",
                       "--labels", "osm-multiclass", "--out", str(tmp_path / "port_run")])
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 6)).astype(np.float32)
    want = _jax_unet_logits(cfg, params, stats, x)
    got = _port_logits(run_dir, x)
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= LOGITS_ATOL
    _, state_dict = io.load_checkpoint(run_dir)
    _assert_state_dicts_equal(state_dict, convert.unet_state_dict_from_jax(params, stats))


def test_jax_mae_run_exports_into_a_port_mae_run_with_the_same_embeddings(tmp_path, monkeypatch):
    """An s2tpu MAE run -> s2tpu ``export-prithvi`` -> the port's
    ``convert_weights prithvi``: the port's embeddings equal s2tpu's
    ``make_embed_fn`` on the original parameters, every pool."""
    monkeypatch.setattr(jax_cw, "load_prithvi_model_args", _tiny_args)
    monkeypatch.setattr(cw, "load_prithvi_model_args", _tiny_args)
    jcfg, params = _jax_tiny_mae(seed=6)
    jconfig = jax_mae_cfg.base_config("small")
    jconfig.datamodule.random_crop_size = 32
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=optax.adam(1e-3).init(params))
    mgr = JaxCheckpointManager(tmp_path / "jax_mae", config_dict=dataclasses.asdict(jconfig))
    mgr.save_epoch(0, state)
    mgr.wait()
    mgr.close()
    jax_cw.main(["export-prithvi", str(tmp_path / "jax_mae"), "--out", str(tmp_path / "prithvi.pt")])
    run_dir = cw.main(["prithvi", str(tmp_path / "prithvi.pt"), "--out", str(tmp_path / "port_mae"),
                       "--num-frames", "1", "--aoi", "small"])
    config, state_dict = io.load_mae_checkpoint(run_dir)
    assert config.model.num_frames == 1 and config.datamodule.dataset_cfg.aoi == "small"
    encoder = load_encoder(state_dict, tm.PrithviConfig.from_model_args(_tiny_args()), torch.float32, "cpu")
    raw = np.random.default_rng(7).integers(0, 4000, size=(3, 32, 32, 6)).astype(np.float32)
    for pool in ("mean", "cls", "tokens"):
        want = np.asarray(jax_make_embed_fn(jm.PrithviMAE(jcfg), MEAN, STD, pool=pool)(params, jnp.asarray(raw)))
        got = make_embed_fn(encoder, MEAN, STD, pool=pool)(raw).numpy()
        assert got.shape == want.shape
        assert _rel(got, want) <= EMBED_RTOL, pool
