"""FSDP and a model axis in s2tpu_torch's segmentation trainer: against the JAX package and against one process.

``SegmentationTrainer(mesh=make_mesh(n, model_parallel=m), param_sharding=...)``
on gloo ranks on the CPU (``torch.multiprocessing.spawn`` from a module
fixture; the rank workers live in the JAX-free
``tests/test_torch_multi_card.py``): B0 at 64^2 crops in f32, focal +
weighted loss, a global batch of 6 on a 1 x 2 mesh (both ranks hold all 6
rows) and on a 2 x 2 mesh (3 rows a data rank), three steps at lr 1e-4.
Meanwhile this process runs ``s2tpu``'s trainer with
``param_sharding="fsdp"`` on ``make_mesh(4, model_parallel=2)`` and the
port's one-process trainer.

- The shard layout: the port's rule (``parallel.mesh.fsdp_shard_dim``)
  shards the same tensors on the same axes as ``fsdp_param_shardings``, B0
  and a tiny fc-prithvi at model axes 2 and 4: each Flax leaf filled with its
  elements' shard index, carried through ``checkpoint/convert.py``'s
  mappings, equals the port's slices' indices.
- Steps: FSDP on 1 x 2 equals the replicated trainer on 1 x 2 bit for bit
  (the same arithmetic on slices). Three steps against the one-process
  steps from the same init (seeded drop-connect) and against ``s2tpu``'s
  from its init (drop-connect keeping every sample): step 1's loss to 1e-5
  relative and its BatchNorm statistics to 1e-5 of max(|ref|, 1), later
  losses to LATER_LOSS_RTOL and the statistics after three steps to
  LATER_STATS_RTOL (train-mode BatchNorm turns f32 rounding in another
  order into drift: measured 1.5e-3 and 5.5e-3), the whole parameters to
  PARAM_ATOL_STEP a step (measured 2e-4 after one). The watch norms: the
  parameters' (the slices' squares summed over the model axis) to
  NORM_RTOL of the gathered state's, the gradients' within the data axis's
  bounds of the one process's (``tests/test_torch_multi_card.py``).
- An epoch through ``fit`` (BatchNorm recalibration, the val pass on the
  gathered EMA, a checkpoint) against one process.
- Checkpoints hold whole tensors: an FSDP run's checkpoint resumes on one
  process and on a data axis alone to the FSDP run's next step, and theirs
  resume under FSDP; ``cli.infer --device cpu`` serves it.
- fc-prithvi (frozen, then unfrozen) under FSDP on 1 x 2 against one process.
- Per-rank bytes: parameters, Adam's state, the f32 master and the EMA on
  each rank are the rule's count: the sharded tensors' elements over m.

PARAM_ATOL_STEP is 2.5 lr: Adam's first steps move a parameter by about
lr whatever its gradient's size, so a gradient that is rounding noise (a
bias before a train-mode BatchNorm) moves by +-lr on a sign that the
summation order picks (``tests/test_torch_data_parallel.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.data.pipeline import Datamodule as JaxDatamodule
from s2tpu.models import prithvi_mae as jm
from s2tpu.models.efficientnet_unet import EfficientNetUNet as JaxUNet
from s2tpu.models.efficientnet_unet import EfficientNetUNetConfig as JaxConfig
from s2tpu.models.prithvi_seg import PrithviSegmentationConfig as JaxSegConfig
from s2tpu.models.prithvi_seg import PrithviSegmentationNet as JaxSegNet
from s2tpu.parallel import mesh as jax_mesh
from s2tpu.train.trainer import SegmentationTrainer as JaxTrainer
from s2tpu_torch.checkpoint.convert import prithvi_seg_state_dict_from_jax, unet_state_dict_from_jax
from s2tpu_torch.models import efficientnet_unet as tu
from s2tpu_torch.models import prithvi_seg as ts
from s2tpu_torch.parallel import mesh as mesh_lib
from s2tpu_torch.train.logging_utils import RunLogger
from tests.test_torch_multi_card import (  # noqa: F401 - dp_data_dir is a fixture
    DP_BATCH, DP_DIST, DP_GRAD_RTOL, DP_TOTAL_GRAD_RTOL, FC_DEPTH, FC_EMBED, FC_HEAD_WIDTH, FC_HEADS, FSDP_LR, FSDP_STEPS, _fsdp_worker, dp_data_dir,
    dp_global_batch, dp_ranks, dp_trainer, fc_dp_global_batch, fc_dp_trainer, fsdp_bytes, fsdp_fit, fsdp_steps,
    join_ranks, resumed, save_checkpoint,
)

SPAWN_TIMEOUT_S = 600  # a guard: the ranks take ~20 s alone, longer beside the suite's other workers
PARAM_ATOL_STEP = 2.5 * FSDP_LR
LATER_LOSS_RTOL, LATER_STATS_RTOL = 5e-3, 1e-2
EPOCH_RTOL = 1e-3  # tests/test_torch_data_parallel.py's epoch bound
NORM_RTOL = 1e-4  # an f32 norm over ~1e6 elements on the CPU: 4.3e-5 from the f64 norm (measured)
FSDP_M = 2  # the model axis of every mesh here
# The spawns, (world, scenarios) each, run side by side: the 1 x 2
# scenarios in two groups of two ranks (the checkpoints resume the "fsdp"
# scenario's trainer), the 2 x 2 ones in four ranks.
SPAWNS = {"2a": (2, ("fsdp", "ckpt")), "2b": (2, ("jax", "replicated", "fit", "fc", "bytes")), "4": (4, ("jax", "fsdp"))}
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_config(data_dir):
    c = jax_cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = DP_BATCH
    c.datamodule.random_crop_size = 64
    c.train.compute_dtype = "float32"
    c.train.loss_type = c.train.loss_type.__class__("focal")
    c.train.weighted_loss = True
    c.train.class_distribution = list(DP_DIST)
    c.train.lr = FSDP_LR
    c.train.watch_interval = 0
    c.train.num_devices = 4
    return c


def _one_process(data_dir, tmp) -> dict:
    """The one-process references the ranks need before they start: three
    steps with the watch norms, the checkpoint the ranks resume from and its
    next step."""
    images, labels = dp_global_batch(data_dir)
    one = dp_trainer(data_dir, None, device="cpu", lr=FSDP_LR, run_logger=RunLogger("one", tmp / "logs_one"),
                     watch_interval=1)
    out = {"steps": fsdp_steps(one, images, labels)}
    save_checkpoint(one, tmp / "ckpt_one")
    out["one_4"] = fsdp_steps(one, images, labels, 1)
    return out


def _one_process_rest(data_dir, tmp) -> dict:
    """The other one-process references (while the ranks run):
    fc-prithvi frozen then unfrozen, an epoch through ``fit``, and the
    bytes of one rank's state."""
    images, labels = dp_global_batch(data_dir)
    out = {}
    fc = fc_dp_trainer(data_dir, None, device="cpu", lr=FSDP_LR)
    fc_images, fc_labels = fc_dp_global_batch(data_dir)
    frozen = fsdp_steps(fc, fc_images, fc_labels, 1)
    fc.unfreeze_backbone()
    out["fc"] = {"frozen": frozen, "unfrozen": fsdp_steps(fc, fc_images, fc_labels, 1)}
    out["fit"] = fsdp_fit(dp_trainer(data_dir, None, device="cpu", lr=FSDP_LR, ema_decay=0.9,
                                     bn_recalibration_batches=1), tmp / "fit_one")
    t = dp_trainer(data_dir, None, device="cpu", lr=FSDP_LR, param_dtype="bfloat16", ema_decay=0.9)
    fsdp_steps(t, images, labels, 1)
    out["bytes"] = fsdp_bytes(t)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dp_data_dir):
    """Every rank's records on 1 x 2 and 2 x 2 meshes (:data:`SPAWNS`,
    side by side, while this process runs the JAX FSDP trainer and the
    rest of the one-process references)."""
    data_dir = str(dp_data_dir)
    tmp = {key: tmp_path_factory.mktemp(f"fsdp{key}") for key in SPAWNS}
    jcfg = _jax_config(dp_data_dir)
    jtrainer = JaxTrainer(jcfg, JaxDatamodule(jcfg.datamodule, process_count=1, process_index=0),
                          mesh=jax_mesh.make_mesh(4, model_parallel=2), param_sharding="fsdp")
    init = unet_state_dict_from_jax(jax.device_get(jtrainer.state.params), jax.device_get(jtrainer.state.batch_stats))
    for key in SPAWNS:
        torch.save(init, tmp[key] / "jax_init.pt")
    # The one-process checkpoint the FSDP ranks resume from, before they start.
    one = _one_process(dp_data_dir, tmp["2a"])
    contexts = {key: torch.multiprocessing.spawn(
        _fsdp_worker, args=(str(tmp[key]), data_dir, world, FSDP_M, scenarios), nprocs=world, join=False)
        for key, (world, scenarios) in SPAWNS.items()}
    try:
        one.update(_one_process_rest(dp_data_dir, tmp["2b"]))
        images, labels = dp_global_batch(dp_data_dir)
        sharding = jax_mesh.data_sharding(jtrainer.mesh)
        sharded_leaves = sum(any(a is not None for a in leaf.sharding.spec)
                             for leaf in jax.tree_util.tree_leaves(jtrainer.state.params))
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.ones(shape, bool))
            state, jlosses, states = jtrainer.state, [], []
            for _ in range(FSDP_STEPS):
                state, jout = jtrainer.train_step(state, jax.device_put(images, sharding),
                                                  jax.device_put(labels, sharding), jtrainer.base_rng)
                jlosses.append(float(jout["loss"]))
                states.append(unet_state_dict_from_jax(jax.device_get(state.params),
                                                       jax.device_get(state.batch_stats)))
    finally:
        for key, ctx in contexts.items():
            join_ranks(ctx, SPAWNS[key][0], SPAWN_TIMEOUT_S, tmp[key])
    records = {key: dp_ranks(tmp[key], world) for key, (world, _) in SPAWNS.items()}
    ranks = {2: [{**a, **b} for a, b in zip(records["2a"], records["2b"])], 4: records["4"]}
    return {"tmp": {2: tmp["2a"], 4: tmp["4"]}, "data_dir": data_dir, "ranks": ranks, "one": one,
            "jax": {"losses": jlosses, "state_1": states[0], "state": states[-1], "sharded_leaves": sharded_leaves}}


# ---------------------------------------------------------------------------
# the shard layout against fsdp_param_shardings
# ---------------------------------------------------------------------------
def _shard_index_tree(params, m: int) -> dict:
    """Each Flax leaf filled with its elements' shard index under
    ``fsdp_param_shardings`` over a model axis of ``m`` (-1: replicated)."""
    mesh = jax_mesh.make_mesh(m, model_parallel=m)
    specs = jax_mesh.fsdp_param_shardings(params, mesh)

    def fill(leaf, sharding):
        out = np.full(np.shape(leaf), -1.0, np.float32)
        for axis, name in enumerate(sharding.spec):
            if name is not None:
                size = leaf.shape[axis]
                idx = (np.arange(size) // (size // m)).reshape([-1 if a == axis else 1 for a in range(leaf.ndim)])
                out = np.broadcast_to(idx, leaf.shape).astype(np.float32)
        return out

    return jax.tree_util.tree_map(fill, params, specs)


def _port_shard_index(model: torch.nn.Module, m: int) -> dict[str, torch.Tensor]:
    """The port's rule as the same picture: each parameter filled with its
    elements' shard index (-1: replicated)."""
    modules = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        dim = mesh_lib.fsdp_shard_dim(modules[name.rpartition(".")[0]], p, m)
        if dim is None:
            out[name] = torch.full(p.shape, -1.0)
        else:
            shape = [-1 if d == dim else 1 for d in range(p.dim())]
            out[name] = (torch.arange(p.shape[dim]) // (p.shape[dim] // m)).float().reshape(shape).expand(p.shape)
    return out


def _zeros(tree):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("model", ["b0", "fc-prithvi"])
def test_shard_layout_equals_fsdp_param_shardings(model, m):
    if model == "b0":
        cfg = JaxConfig(version="b0", in_channels=6, num_classes=4, class_distribution=DP_DIST)
        shapes = jax.eval_shape(lambda: JaxUNet(cfg).init(jax.random.key(0), jnp.zeros((1, 64, 64, 6)), train=False))
        port = tu.EfficientNetUNet(tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=4))

        def convert(params, stats):
            return unet_state_dict_from_jax(params, stats)
    else:
        widths = dict(img_size=64, patch_size=16, num_frames=1, in_chans=6, embed_dim=FC_EMBED, depth=FC_DEPTH,
                      num_heads=FC_HEADS, decoder_embed_dim=48, decoder_depth=1, decoder_num_heads=4)
        seg = dict(num_frames=1, num_classes=4, fcn_out_channels=FC_HEAD_WIDTH, fcn_num_convs=1, fcn_dropout=0.1,
                   frozen_backbone=True, embed_dim=FC_EMBED, patch_height=4, patch_width=4)
        shapes = jax.eval_shape(lambda: JaxSegNet(JaxSegConfig(**seg, backbone=jm.PrithviConfig(**widths))).init(
            jax.random.key(0), jnp.zeros((1, 1, 64, 64, 6))))
        backbone = ts.PrithviConfig(**widths)
        port = ts.PrithviSegmentationNet(ts.PrithviSegmentationConfig(**seg, backbone=backbone))

        def convert(params, stats):
            return prithvi_seg_state_dict_from_jax(params, stats, backbone)
    params = _zeros(shapes["params"])
    expected = convert(_shard_index_tree(params, m), _zeros(shapes["batch_stats"]))
    ours = _port_shard_index(port, m)
    assert set(ours) <= set(expected)
    sharded = [n for n, t in ours.items() if bool((t >= 0).all())]
    assert sharded, "the rule shards nothing"
    for name, t in ours.items():
        assert torch.equal(t, expected[name]), name
    # the JAX rule's count of sharded leaves
    n_jax = sum(any(a is not None for a in s.spec) for s in jax.tree_util.tree_leaves(
        jax_mesh.fsdp_param_shardings(params, jax_mesh.make_mesh(m, model_parallel=m))))
    assert len(sharded) == n_jax


# ---------------------------------------------------------------------------
# steps on 1 x 2 and 2 x 2 meshes
# ---------------------------------------------------------------------------
def _assert_state_close(state: dict, ref: dict, param_atol: float, stats_rtol: float) -> None:
    assert set(state) == set(ref)
    for n, t in ref.items():
        if "running" in n:
            assert float(((state[n] - t).abs() / t.abs().clamp_min(1.0)).max()) <= stats_rtol, n
        elif t.is_floating_point():
            assert float((state[n] - t).abs().max()) <= param_atol, n


def _assert_steps_close(ours: dict, ref: dict) -> None:
    """Three steps against a run from the same init that sums in other
    orders: step 1 to the data axis's bounds, the later steps to the drift
    that train-mode BatchNorm makes of rounding."""
    losses, ref_losses = [s["loss"] for s in ours["steps"]], [s["loss"] for s in ref["steps"]]
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses[1:], ref_losses[1:], rtol=LATER_LOSS_RTOL)
    _assert_state_close(ours["state_1"], ref["state_1"], PARAM_ATOL_STEP, 1e-5)
    _assert_state_close(ours["state"], ref["state"], PARAM_ATOL_STEP * FSDP_STEPS, LATER_STATS_RTOL)


@pytest.mark.parametrize("world", list(WORLDS))
def test_fsdp_steps_match_the_one_process_steps(world, runs):
    ranks, one = runs["ranks"][world], runs["one"]["steps"]
    first = ranks[0]["fsdp"]
    assert first["axes"] == (world // 2, 2) and first["sharded"]
    for rank in ranks:  # the model peers gather the same whole state, Adam's too; the data ranks too
        assert rank["fsdp"]["digest"] == first["digest"]
        assert rank["fsdp"]["whole_digest"] == first["whole_digest"]
        assert [s["loss"] for s in rank["fsdp"]["steps"]] == [s["loss"] for s in first["steps"]]
    _assert_steps_close(first, one)
    # The watch norms: the parameters' are the gathered state's (the
    # slices' squares summed over the model axis); the gradients' within the
    # data axis's bounds of the one process's, step 1.
    last = first["steps"][-1]["watch"]
    for name, t in first["state"].items():
        if f"params/{name}" in last:
            norm = float(torch.linalg.vector_norm(t.double()))
            assert abs(last[f"params/{name}"] - norm) <= NORM_RTOL * norm, name
    ours, ref = first["steps"][0]["watch"], one["steps"][0]["watch"]
    assert set(ours) == set(ref) and len(ref) > 2
    total = ref["grads/global_norm"]
    assert abs(ours["grads/global_norm"] - total) <= DP_TOTAL_GRAD_RTOL * total
    for k, v in ref.items():
        if k.startswith("grads/"):
            assert abs(ours[k] - v) <= DP_GRAD_RTOL * v + 1e-6 * total, k


def test_fsdp_equals_the_replicated_trainer_bit_for_bit(runs):
    for rank in runs["ranks"][2]:
        assert rank["replicated"]["digest"] == rank["fsdp"]["digest"]
        assert rank["replicated"]["whole_digest"] == rank["fsdp"]["whole_digest"]  # Adam's state too
        assert [s["loss"] for s in rank["replicated"]["steps"]] == [s["loss"] for s in rank["fsdp"]["steps"]]
    assert runs["ranks"][2][0]["replicated"]["sharded"] == []


@pytest.mark.parametrize("world", list(WORLDS))
def test_fsdp_steps_match_the_jax_fsdp_trainer(world, runs):
    ref = runs["jax"]
    ours = runs["ranks"][world][0]["jax"]
    subset = {k: {n: t for n, t in ref[k].items() if n in ours[k]} for k in ("state", "state_1")}
    _assert_steps_close(ours, {"steps": [{"loss": v} for v in ref["losses"]], **subset})
    # s2tpu's rule sharded as many parameter tensors as the port's
    assert ref["sharded_leaves"] == len(runs["ranks"][world][0]["fsdp"]["sharded"])


# ---------------------------------------------------------------------------
# checkpoints both ways, serving
# ---------------------------------------------------------------------------
def _assert_step_close(a: dict, b: dict) -> None:
    np.testing.assert_allclose(a["steps"][0]["loss"], b["steps"][0]["loss"], rtol=1e-5)
    _assert_state_close(a["state"], b["state"], 2.5 * FSDP_LR, 1e-5)


def test_checkpoints_pass_between_fsdp_a_data_axis_and_one_process(runs):
    from s2tpu_torch.checkpoint.io import CheckpointManager

    tmp, rec = runs["tmp"][2], runs["ranks"][2][0]["ckpt"]
    # whole tensors on disk, as one process writes them
    saved = CheckpointManager(tmp / "ckpt_fsdp").restore(0)["model"]
    assert all(torch.equal(saved[n], t) for n, t in runs["ranks"][2][0]["fsdp"]["state"].items())
    # the FSDP run's checkpoint, resumed in one process: the FSDP run's next step
    images, labels = dp_global_batch(runs["data_dir"])
    one = resumed(dp_trainer(runs["data_dir"], None, device="cpu", lr=FSDP_LR), tmp / "ckpt_fsdp")
    assert one.step == FSDP_STEPS
    _assert_step_close(fsdp_steps(one, images, labels, 1), rec["fsdp_4"])
    # ... and on a data axis alone, whose checkpoint FSDP resumes to the data axis's next step
    _assert_step_close(rec["data_4"], rec["fsdp_4"])
    _assert_step_close(rec["fsdp_5"], rec["data_5"])
    # a one-process checkpoint resumed under FSDP: the one process's next step
    _assert_step_close(rec["from_one_4"], runs["one"]["one_4"])
    for rank in runs["ranks"][2][1:]:
        assert {k: v["digest"] for k, v in rank["ckpt"].items()} == {k: v["digest"] for k, v in rec.items()}


def test_cli_infer_serves_an_fsdp_checkpoint(runs, tmp_path):
    """The FSDP run directory serves as the serving checkpoint of its whole
    state does, file for file."""
    from s2tpu_torch.checkpoint import io
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.configs.segmentation import config_to_dict
    from tests.test_torch_multi_card import dp_config

    config = dp_config(runs["data_dir"])
    run = runs["tmp"][2] / "ckpt_fsdp"
    (run / io.CONFIG_FILE).write_text(json.dumps(config_to_dict(config), default=str))
    plain = io.save_checkpoint(tmp_path / "plain", config, runs["ranks"][2][0]["fsdp"]["state"])
    served = {}
    for name, ckpt in (("fsdp", run), ("plain", plain)):
        out = tmp_path / f"out_{name}"
        infer_main([str(ckpt), "--tiled", "--device", "cpu", "--out", str(out), "--data-dir", runs["data_dir"]])
        served[name] = {p.name: p.read_bytes() for p in sorted(out.glob("pred_*.tif"))}
    assert served["fsdp"] and served["fsdp"] == served["plain"]


def test_fsdp_fit_recalibrates_evaluates_and_checkpoints_as_one_process(runs):
    """An epoch through ``fit`` under FSDP (two steps, BatchNorm
    recalibration and the val pass on the gathered EMA, the checkpoint
    written whole by rank 0) against one process: the train and val losses
    to EPOCH_RTOL (the steps' rounding carried into the
    weights; the pixel metrics, a few pixels of 16,384 apart, to EPOCH_RTOL
    absolute: measured 9e-5), the checkpoint's parameters to 2 x
    PARAM_ATOL_STEP."""
    ours, ref = runs["ranks"][2][0]["fit"], runs["one"]["fit"]
    assert runs["ranks"][2][1]["fit"]["record"] == ours["record"]
    assert set(ours["record"]) == set(ref["record"])
    for k, v in ref["record"].items():
        if "loss" in k:
            np.testing.assert_allclose(ours["record"][k], v, rtol=EPOCH_RTOL, err_msg=k)
        elif k.split("/")[-1].startswith(("iou", "accuracy", "f1")):
            np.testing.assert_allclose(ours["record"][k], v, atol=EPOCH_RTOL, err_msg=k)
    _assert_state_close(ours["model"], ref["model"], 2 * PARAM_ATOL_STEP, LATER_STATS_RTOL)


# ---------------------------------------------------------------------------
# fc-prithvi, per-rank bytes
# ---------------------------------------------------------------------------
def test_fc_prithvi_frozen_then_unfrozen_under_fsdp_matches_one_process(runs):
    ranks, ref = runs["ranks"][2], runs["one"]["fc"]
    first = ranks[0]["fc"]
    assert any(n.startswith("backbone.") for n in first["sharded"])
    for phase in ("frozen", "unfrozen"):
        assert all(r["fc"][phase]["digest"] == first[phase]["digest"] for r in ranks)
        np.testing.assert_allclose(first[phase]["steps"][0]["loss"], ref[phase]["steps"][0]["loss"], rtol=1e-5)
        _assert_state_close(first[phase]["state"], ref[phase]["state"], 2.5 * FSDP_LR * (1 + (phase == "unfrozen")),
                            1e-5 + 2 * 0.1 * FSDP_LR)


def test_each_rank_holds_the_rules_share_of_the_state_bytes(runs):
    """Parameters in bf16, their f32 masters, EMA and two Adam moments, and
    Adam's step count (one f32 a parameter): the sharded tensors' elements
    over m, the rest whole."""
    model = tu.EfficientNetUNet(tu.EfficientNetUNetConfig(version="b0", in_channels=6, num_classes=4))
    modules = dict(model.named_modules())
    m = 2
    local = whole = 0
    for name, p in model.named_parameters():
        sharded = mesh_lib.fsdp_shard_dim(modules[name.rpartition(".")[0]], p, m) is not None
        per_element = 2 + 4 + 4 + 8
        whole += p.numel() * per_element + 4
        local += p.numel() // (m if sharded else 1) * per_element + 4
    assert runs["one"]["bytes"] == whole
    assert [r["bytes"] for r in runs["ranks"][2]] == [local, local]
    assert local < 0.6 * whole
