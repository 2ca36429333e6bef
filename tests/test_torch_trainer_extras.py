"""The trainer extras (gradient accumulation, remat, bf16 parameters with an f32 master, parameter EMA, watch norms, BN recalibration): s2tpu_torch's trainers vs the JAX package's, and within the port.

Against JAX: B0 at 64^2 crops in f32 compute, augmentation and drop-connect
off (the same all-keep mask on both sides), the JAX init carried into the
port by the converter, the same batch. Accumulation runs at batch 4 in two
micro-batches of 2: train-mode BatchNorm over the deepest 2 x 2 maps of a
single sample would be conditioned too badly for any comparison.

Tolerances. As in ``test_torch_train.py``: the loss to 1e-5 relative, the
running statistics to 1e-4 relative (floor 1), per-tensor gradients to
GRAD_RTOL relative L2 and all of them to TOTAL_GRAD_RTOL, because
train-mode BatchNorm amplifies the f32 rounding of sums taken in another
order. Adam's first update moves each element by lr * g'/(|g'| + eps), about
lr in the direction of g' = g + wd * p: every entry agrees to 2 lr, and to
1e-3 lr where g' is clear of the gradient noise (above CLEAR times its root
mean square over a tensor whose gradient is not rounding noise: more than
1e-6 of all gradients' norm; a bias followed by BatchNorm has a zero
gradient up to rounding). Later updates follow gradients taken at weights
that already differ so: every entry agrees to 2 lr a step, and the
movement from the initial weights of all tensors together to
SEG_MOVE_RTOL (measured 0.077 after two steps, 0.054 for the EMA after
three) or MAE_MOVE_RTOL (measured 0.010) in relative L2. The EMA is a
weighted sum of such weights and takes the same bounds. A bf16 parameter is
the cast of its master to nearest on both sides, so two differ by at most
their masters' difference and half a bf16 ulp of each. Watch norms: a
parameter's to 1e-5 relative plus its first update's 2 lr an entry, a
gradient's as gradients above (the ViT's to 1e-3: LayerNorm is well
conditioned). The MAE runs at batch 2 in two micro-batches of 1, each with
the masking noise of the JAX micro-batch.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.configs import mae as jax_mae_cfg
from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.data.pipeline import Datamodule as JaxDatamodule
from s2tpu.models.prithvi_mae import PrithviConfig as JaxPrithviConfig
from s2tpu.parallel import mesh as mesh_lib
from s2tpu.train.mae_trainer import MAETrainer as JaxMAETrainer
from s2tpu.train.logging_utils import RunLogger as JaxRunLogger
from s2tpu.train.trainer import SegmentationTrainer as JaxTrainer
from s2tpu.train.trainer import pool_batch_stats as jax_pool_batch_stats
from s2tpu.train.train_state import EmaState, MasterState
from s2tpu_torch.checkpoint.convert import prithvi_state_dict_from_jax, unet_state_dict_from_jax
from s2tpu_torch.configs import mae as mae_cfg
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.data.pipeline import Datamodule
from s2tpu_torch.models import efficientnet_unet as tu
from s2tpu_torch.models.prithvi_mae import PrithviConfig
from s2tpu_torch.train.logging_utils import RunLogger
from s2tpu_torch.train.mae_trainer import MAETrainer
from s2tpu_torch.train.trainer import SegmentationTrainer, pool_batch_stats

LR, WD = 1e-4, 0.05  # WD: the configs' coupled L2
GRAD_RTOL, TOTAL_GRAD_RTOL = 5e-2, 2.5e-2
CLEAR = 0.5
SEG_MOVE_RTOL, MAE_MOVE_RTOL = 0.2, 0.05


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch CPU threads in this module: the suite runs several workers
    on one machine, where torch's default of one thread per core makes its
    workers thrash (the module's checks compare runs within one process)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_name(path) -> str:
    """The JAX watch norms' name of a leaf (``trainer._watch_norms``)."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _jax_parts(state):
    """(f32 master or None, EMA or None) of a JAX train state."""
    opt = state.opt_state
    inner = opt.inner if isinstance(opt, EmaState) else opt
    return (inner.master if isinstance(inner, MasterState) else None), (opt.ema if isinstance(opt, EmaState) else None)


def _unet_names(params, stats) -> dict[str, str]:
    """Port parameter name -> JAX leaf name, through the converter: each leaf
    is filled with its own number, which the conversion's transposes keep."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    ids = jax.tree_util.tree_unflatten(treedef, [np.full(np.shape(v), i + 1.0, np.float32)
                                                for i, (_, v) in enumerate(leaves)])
    converted = unet_state_dict_from_jax(ids, jax.tree_util.tree_map(np.zeros_like, stats))
    out = {}
    for name, t in converted.items():
        if "running" not in name and "num_batches" not in name:
            i = int(t.flatten()[0])
            assert float(t.min()) == float(t.max()) == i, name
            out[name] = _jax_name(leaves[i - 1][0])
    return out


def _seg_configs(fixture_dir, batch: int = 4, **train):
    out = []
    for lib in (jax_cfg_lib, cfg_lib):
        c = lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
        c.datamodule.dataset_cfg.data_dir = str(fixture_dir)
        c.datamodule.batch_size = batch
        c.datamodule.random_crop_size = 64
        c.datamodule.data_split = (1.0, 0.0, 0.0)
        c.datamodule.augment = False
        c.train.compute_dtype = "float32"
        c.train.num_devices = 1
        c.train.lr = LR
        c.train.watch_interval = 0
        for k, v in train.items():
            setattr(c.train, k, v)
        out.append(c)
    return out


def _seg_pair(fixture_dir, tmp_path, monkeypatch, batch: int = 4, **train):
    """(JAX trainer, port trainer) at the same init, drop-connect off."""
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.ones(shape, bool))
    monkeypatch.setattr(tu, "drop_connect_mask",
                        lambda batch, keep, generator, device: torch.ones(batch, 1, 1, 1, dtype=torch.bool))
    jc, pc = _seg_configs(fixture_dir, batch, **train)
    jdm = JaxDatamodule(jc.datamodule, process_count=1, process_index=0)
    dm = Datamodule(pc.datamodule)
    dm.set_mean_std(*jdm.mean_std())
    watch = train.get("watch_interval", 0) > 0
    jt = JaxTrainer(jc, jdm, run_logger=JaxRunLogger("j", tmp_path / "jax", use_wandb=False) if watch else None)
    pt = SegmentationTrainer(pc, dm, run_logger=RunLogger("p", tmp_path / "port") if watch else None, device="cpu")
    master, _ = _jax_parts(jt.state)
    params = jax.device_get(master if master is not None else jt.state.params)
    state = unet_state_dict_from_jax(params, jax.device_get(jt.state.batch_stats))
    pt.model.load_state_dict(state, strict=True)  # cast into bf16 parameters under bf16 storage
    for part in (pt.master, pt.ema):
        if part is not None:
            part.load_state_dict(state)
    return jt, pt


def _first_update_close(ours: torch.Tensor, theirs: torch.Tensor, init: torch.Tensor, grad: torch.Tensor,
                        share: float, what: str) -> None:
    """After one step, the bounds of the module docstring."""
    d = (ours.double() - theirs.double()).abs() / LR
    assert float(d.max()) <= 2.0 + 1e-3, (what, float(d.max()))
    if share > 1e-6:
        g = (grad + WD * init).double().abs()
        clear = g > CLEAR * g.square().mean().sqrt()
        assert float(d[clear].max()) <= 1e-3, (what, float(d[clear].max()))


def _movements_close(ours: dict, theirs: dict, init: dict, steps: int, rtol: float) -> None:
    """After ``steps`` steps, the bounds of the module docstring."""
    diff2 = move2 = 0.0
    for name, t in theirs.items():
        d = (ours[name].double() - t.double()).abs()
        assert float(d.max()) <= (2.0 * steps + 1e-3) * LR, (name, float(d.max()) / LR)
        diff2 += float(d.square().sum())
        move2 += float((t.double() - init[name].double()).square().sum())
    assert math.sqrt(diff2 / move2) <= rtol, math.sqrt(diff2 / move2)


def _update_grads(trainer) -> tuple[dict[str, torch.Tensor], dict[str, float]]:
    """The f32 gradients of the trainer's last update by parameter name (on
    the masters under bf16 storage), and each one's share of their norm."""
    named = dict(trainer.model.named_parameters())
    targets = trainer.master.master if trainer.master is not None else named
    grads = {n: targets[n].grad.detach() for n in named}
    total = float(torch.cat([g.flatten() for g in grads.values()]).norm())
    return grads, {n: float(g.norm()) / total for n, g in grads.items()}


def _f32_weights(trainer) -> dict[str, torch.Tensor]:
    """The f32 weights the optimizer walks: the masters or the parameters."""
    if trainer.master is not None:
        return {n: m.detach().clone() for n, m in trainer.master.master.items()}
    return {n: p.detach().float().clone() for n, p in trainer.model.named_parameters()}


def _running_stats_close(model: torch.nn.Module, ref: dict) -> None:
    for name, buf in model.named_buffers():
        if "running" in name:
            err = (buf - ref[name]).abs() / ref[name].abs().clamp_min(1.0)
            assert float(err.max()) <= 1e-4, name


def test_accumulation_bf16_master_ema_and_watch_track_the_jax_trainer(fixture_dir, tmp_path, monkeypatch):
    """accum 2, bf16 parameters with the f32 master, EMA 0.5 and watching at
    every step, three steps on the same batch. After one: loss, confusion
    matrix, running statistics, the masters' update and the watch norms.
    After three: the masters, the EMA (of the masters), and the bf16
    parameters, each exactly its master's cast."""
    jt, pt = _seg_pair(fixture_dir, tmp_path, monkeypatch, grad_accum_steps=2, param_dtype="bfloat16",
                       ema_decay=0.5, watch_interval=1)
    jstats = jax.device_get(jt.state.batch_stats)
    names = _unet_names(jax.device_get(jt.state.params), jstats)
    batch = next(pt.dm.train_batches(0))
    images, labels = torch.from_numpy(batch.images), torch.from_numpy(batch.labels)
    init = _f32_weights(pt)
    state = jt.state
    for step in range(3):
        state, jm = jt.train_step(state, jnp.asarray(batch.images), jnp.asarray(batch.labels), jt.base_rng,
                                  with_watch=True)
        m = pt.train_step(images, labels)
        if step:
            continue
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        cm, jcm = m["cm"].numpy(), np.asarray(jm["cm"])
        assert cm.sum() == jcm.sum() and np.abs(cm - jcm).sum() <= 1e-3 * cm.sum()
        stats = jax.device_get(state.batch_stats)
        _running_stats_close(pt.model, unet_state_dict_from_jax(jax.device_get(_jax_parts(state)[0]), stats))
        master = unet_state_dict_from_jax(jax.device_get(_jax_parts(state)[0]), stats)
        grads, shares = _update_grads(pt)
        for name, mine in pt.master.master.items():
            _first_update_close(mine, master[name], init[name], grads[name], shares[name], name)
        # watch norms: the JAX names through the converter's map
        watch = dict(zip(m["watch"][0], m["watch"][1].tolist()))
        jwatch = {k: float(v) for k, v in jm["watch"].items()}
        # JAX sums the squares of a bf16 tree in bf16 for its global norm of the
        # parameters; its per-tensor norms are f32, and their root sum of squares
        # takes their bound (half a bf16 ulp)
        jglobal = math.sqrt(sum(jwatch[f"params/{j}"] ** 2 for j in names.values()))
        np.testing.assert_allclose(watch["params/global_norm"], jglobal, rtol=2.0**-8)
        assert abs(watch["grads/global_norm"] / jwatch["grads/global_norm"] - 1) <= TOTAL_GRAD_RTOL
        total = jwatch["grads/global_norm"]
        for name, jname in names.items():
            # a bf16 parameter: its master's first-update bound and half an ulp each side
            slack = 2 * LR * math.sqrt(init[name].numel()) + 2.0**-8 * 2 * jwatch[f"params/{jname}"]
            assert abs(watch[f"params/{name}"] - jwatch[f"params/{jname}"]) <= slack, name
            ours, theirs = watch[f"grads/{name}"], jwatch[f"grads/{jname}"]
            assert abs(ours - theirs) <= GRAD_RTOL * theirs + 1e-6 * total, (name, ours, theirs)
    # the third step's forward runs on bf16 parameters that may differ by an
    # ulp (2^-8) where the masters straddle a rounding boundary
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-2)
    jmaster, jema = _jax_parts(state)
    stats = jax.device_get(state.batch_stats)
    master = unet_state_dict_from_jax(jax.device_get(jmaster), stats)
    _movements_close(pt.master.master, {n: master[n] for n in init}, init, 3, SEG_MOVE_RTOL)
    ema = unet_state_dict_from_jax(jax.device_get(jema), stats)
    _movements_close(pt.ema.ema, {n: ema[n] for n in init}, init, 3, SEG_MOVE_RTOL)
    params = unet_state_dict_from_jax(jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32),
                                                             jax.device_get(state.params)), stats)
    for name, p in pt.model.named_parameters():
        mine = pt.master.master[name]
        assert p.dtype == torch.bfloat16 and mine.dtype == torch.float32, name
        assert torch.equal(p.detach(), mine.to(torch.bfloat16)), name
        # each side rounds its master to nearest: the casts differ by at most
        # the masters' difference and half a bf16 ulp of each
        bound = (mine - master[name]).abs() + 2.0**-8 * (mine.abs() + master[name].abs())
        assert bool(((p.detach().float() - params[name]).abs() <= bound).all()), name


def test_pooled_bn_statistics_equal_the_jax_pooling():
    """``pool_batch_stats`` on the same per-batch statistics as the JAX
    function's, and both on the statistics of the union (f64 pooling: 1e-6)."""
    rng = np.random.default_rng(0)
    batches = [rng.normal(2.0 * i, 1.0 + i, size=(64, 5)).astype(np.float32) for i in range(3)]
    stats = [(b.mean(0), b.var(0)) for b in batches]
    theirs = jax_pool_batch_stats([{"bn": {"mean": m, "var": v}} for m, v in stats])["bn"]
    mean, var = pool_batch_stats([(torch.from_numpy(m), torch.from_numpy(v)) for m, v in stats])
    np.testing.assert_allclose(mean.numpy(), theirs["mean"], rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), theirs["var"], rtol=1e-6)
    union = np.concatenate(batches)
    np.testing.assert_allclose(var.numpy(), union.var(0), rtol=1e-5)


def test_bn_recalibration_equals_the_jax_trainer(fixture_dir, tmp_path, monkeypatch):
    """recalibrate_bn over the same two train batches of epoch 0, same
    weights, drop-connect off: the running statistics as the JAX pass pools
    them (within the forward's f32 tolerance, 1e-4 relative)."""
    jt, pt = _seg_pair(fixture_dir, tmp_path, monkeypatch, batch=2, bn_recalibration_batches=2)
    jt.recalibrate_bn(n_batches=2)
    pt.recalibrate_bn(n_batches=2)
    ref = unet_state_dict_from_jax(jax.device_get(jt.state.params), jax.device_get(jt.state.batch_stats))
    _running_stats_close(pt.model, ref)
    assert not torch.equal(pt.model.encoder.stem[1].running_var, torch.ones_like(ref["encoder.stem.1.running_var"]))


# ------------------------------------------------------------------- MAE ----
TINY = dict(img_size=32, patch_size=8, num_frames=1, tubelet_size=1, in_chans=6, embed_dim=64, depth=2,
            num_heads=4, decoder_embed_dim=48, decoder_depth=1, decoder_num_heads=4, attention_impl="fused")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_mae_accumulation_remat_ema_track_the_jax_trainer(fixture_dir, tmp_path, param_dtype):
    """The MAE step with accum 2, remat, EMA 0.5 and watching, the masking
    noise of each JAX micro-batch passed in: loss and watch scalars after one
    step, the (master's) parameters and the EMA after two, to the bounds of
    the module docstring (the ViT's gradients are well conditioned, so the
    loss agrees to 1e-5 on both steps)."""
    from tests.test_torch_mae_trainer import _datamodules

    configs = []
    for lib in (jax_mae_cfg, mae_cfg):
        c = lib.base_config(aoi="small")
        c.datamodule.dataset_cfg.data_dir = str(fixture_dir)
        c.datamodule.batch_size, c.datamodule.random_crop_size = 2, 32
        c.datamodule.data_split, c.datamodule.augment = (1.0, 0.0, 0.0), False
        c.model.mask_ratio = 0.5
        c.train.from_scratch, c.train.lr = True, LR
        c.train.grad_accum_steps, c.train.remat, c.train.ema_decay = 2, True, 0.5
        c.train.param_dtype, c.train.watch_interval = param_dtype, 1
        configs.append(c)
    jc, pc = configs
    jdm, dm = _datamodules(fixture_dir, 32, 2)
    jt = JaxMAETrainer(jc, jdm, mesh=mesh_lib.make_mesh(1), model_config=JaxPrithviConfig(**TINY),
                       run_logger=JaxRunLogger("j", tmp_path, use_wandb=False))
    pt = MAETrainer(pc, dm, model_config=PrithviConfig(**TINY), run_logger=RunLogger("p", tmp_path), device="cpu")
    master, _ = _jax_parts(jt.state)
    init = prithvi_state_dict_from_jax(jax.device_get(master if master is not None else jt.state.params),
                                       pt.model_config)
    pt.model.load_state_dict(init, strict=True)
    for part in (pt.master, pt.ema):
        if part is not None:
            part.load_state_dict(init)
    batch = next(dm.train_batches(0)).images
    init = _f32_weights(pt)
    state = jt.state
    for step in range(2):
        step_rng = jax.random.fold_in(jt.base_rng, step)
        noise = np.concatenate([
            np.asarray(jax.random.uniform(jax.random.split(jax.random.fold_in(step_rng, i))[1],
                                          (1, pt.model_config.num_patches)))
            for i in range(2)
        ])
        state, jm = jt.train_step(state, jnp.asarray(batch), jt.base_rng)
        m = pt.train_step(torch.from_numpy(batch), noise=torch.from_numpy(noise))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        if step == 0:
            watch = dict(zip(m["watch"][0], m["watch"][1].tolist()))
            # JAX sums a bf16 tree's squares in bf16: 2^-7 there
            param_rtol = 1e-5 if param_dtype == "float32" else 2.0**-7
            np.testing.assert_allclose(watch["params/global_norm"], float(jm["watch"]["params/global_norm"]),
                                       rtol=param_rtol)
            np.testing.assert_allclose(watch["grads/global_norm"], float(jm["watch"]["grads/global_norm"]), rtol=1e-3)
    jmaster, jema = _jax_parts(state)
    theirs = prithvi_state_dict_from_jax(jax.device_get(jmaster if jmaster is not None else state.params),
                                         pt.model_config)
    ema = prithvi_state_dict_from_jax(jax.device_get(jema), pt.model_config)
    ours = _f32_weights(pt)
    _movements_close(ours, {n: theirs[n] for n in init}, init, 2, MAE_MOVE_RTOL)
    _movements_close(pt.ema.ema, {n: ema[n] for n in init}, init, 2, MAE_MOVE_RTOL)
    assert {p.dtype for p in pt.model.parameters()} == {getattr(torch, param_dtype)}


# ------------------------------------------------------- within the port ----
def _port_trainer(fixture_dir, **train):
    _, c = _seg_configs(fixture_dir, batch=2, **train)
    return SegmentationTrainer(c, Datamodule(c.datamodule), device="cpu")


def test_remat_equals_no_remat_with_drop_connect_and_updates_bn_once(fixture_dir):
    """One step with remat against one without, same init and seed,
    drop-connect on (the masks drawn before each checkpointed block): the same
    loss, gradients and running statistics to f32 rounding (1e-6 relative;
    the recompute repeats the same operations), and every BatchNorm counted
    one update."""
    runs = []
    for remat in (False, True):
        t = _port_trainer(fixture_dir, remat=remat)
        batch = next(t.dm.train_batches(0))
        m = t.train_step(torch.from_numpy(batch.images), torch.from_numpy(batch.labels))
        runs.append((t, float(m["loss"])))
    (plain, loss), (remat, remat_loss) = runs
    assert remat.model.remat and not plain.model.remat
    assert remat.model.encoder.blocks[-1].drop_rate > 0  # drop-connect is on
    np.testing.assert_allclose(remat_loss, loss, rtol=1e-6)
    grads = dict(plain.model.named_parameters())
    for name, p in remat.model.named_parameters():
        torch.testing.assert_close(p.grad, grads[name].grad, rtol=1e-6, atol=1e-9, msg=name)
    buffers = dict(plain.model.named_buffers())
    for name, b in remat.model.named_buffers():
        torch.testing.assert_close(b, buffers[name], rtol=1e-6, atol=1e-9, msg=name)
        if name.endswith("num_batches_tracked"):
            assert int(b) == 1, name


def test_ema_and_master_carry_across_unfreeze(fixture_dir, monkeypatch):
    """fc-prithvi (tiny) frozen with bf16 parameters and an EMA: the
    transition's fresh Adam walks the same f32 masters, which stay exact, and
    the EMA object and values carry over (``tests/test_ema.py:143``,
    ``tests/test_bands_unfreeze.py:304``); training then moves the backbone's
    masters."""
    from tests.test_torch_prithvi_seg import _port_trainer as _fc_trainer
    from tests.test_torch_prithvi_seg import _tiny_port

    _tiny_port(monkeypatch)
    t = _fc_trainer(fixture_dir, frozen_backbone=True, param_dtype="bfloat16", ema_decay=0.9)
    batch = next(t.dm.train_batches(0))
    images, labels = torch.from_numpy(batch.images), torch.from_numpy(batch.labels)
    t.train_step(images, labels)
    master = {n: m.clone() for n, m in t.master.master.items()}
    ema, ema_state = t.ema, {n: e.clone() for n, e in t.ema.ema.items()}
    t.unfreeze_backbone()
    assert t.ema is ema and all(torch.equal(e, ema_state[n]) for n, e in t.ema.ema.items())
    assert all(torch.equal(m, master[n]) for n, m in t.master.master.items())
    assert {id(p) for g in t.optimizer.param_groups for p in g["params"]} == {id(m) for m in t.master.master.values()}
    t.train_step(images, labels)
    name = "backbone.blocks.0.attn.qkv.weight"
    assert not torch.equal(t.master.master[name], master[name])
    assert not torch.equal(t.ema.ema[name], ema_state[name])


def test_cli_serves_and_exports_the_ema_and_logs_the_norms(fixture_dir, tmp_path, monkeypatch):
    """A CLI run with --ema-decay, bf16 parameters, remat, --watch-interval 1
    and --bn-recal 1: the checkpoint holds bf16 parameters, f32 masters and
    the EMA; ``cli.infer`` and ``export-unet`` take the EMA by default and the
    raw weights with ``--no-ema`` (``tests/test_ema.py:168``); the JSONL log
    has the norms of every step."""
    from s2tpu_torch.checkpoint import io
    from s2tpu_torch.cli import convert_weights as cw
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.cli.train_segmentation import main as train_main
    from s2tpu_torch.configs import paths

    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    train_main(["small", "osm-multiclass", "efficientnet-unet-b0", "--bs", "2", "--crop", "64", "--compute-dtype",
                "float32", "--epochs", "1", "--data-dir", str(fixture_dir), "--name", "ema", "--device", "cpu",
                "--ema-decay", "0.5", "--param-dtype", "bfloat16", "--remat", "--watch-interval", "1",
                "--bn-recal", "1"])
    (run_dir,) = (tmp_path / "ckpts").glob("*/ema_*")
    restored = io.CheckpointManager(run_dir).restore(0)
    params = [n for n, v in restored["master"].items()]
    assert all(restored["model"][n].dtype == torch.bfloat16 and restored["master"][n].dtype == torch.float32
               for n in params)
    ema, raw = restored["ema"], restored["model"]
    assert any(not torch.equal(ema[n].to(torch.bfloat16), raw[n]) for n in params)
    logged = [json.loads(line) for line in (tmp_path / "logs" / "runs" / f"{run_dir.name}.metrics.jsonl").open()]
    assert [line["step"] for line in logged if "grads/global_norm" in line] == [1, 2]

    served = []
    load = io.load_checkpoint
    monkeypatch.setattr(io, "load_checkpoint", lambda *a, **kw: served.append(load(*a, **kw)[1]) or load(*a, **kw))
    for flags in ([], ["--no-ema"]):
        infer_main([str(run_dir), "--tiled", "--device", "cpu", "--out", str(tmp_path / "preds"), "--data-dir",
                    str(fixture_dir), *flags])
        cw.main(["export-unet", str(run_dir), "--out", str(tmp_path / "unet.pt"), *flags])
        exported = torch.load(tmp_path / "unet.pt", weights_only=True)
        want = ema if not flags else raw
        assert all(torch.equal(served[-1][n], want[n]) for n in params)
        assert all(torch.equal(exported[n], want[n].float()) for n in params)
        assert torch.equal(exported["encoder.stem.1.running_var"], raw["encoder.stem.1.running_var"])
