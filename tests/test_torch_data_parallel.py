"""The data axis of s2tpu_torch's segmentation trainer: N ranks, one process each, against one process and against the JAX package.

Ranks are gloo processes on the CPU (``torch.multiprocessing.spawn``, a
file:// store in a tmp dir, a spawn timeout), spawned once per world size
for the module; their records come back through ``torch.save``. The
workers, and the helpers that the NCCL card tests share, live in the
JAX-free ``tests/test_torch_multi_card.py``. B0 at 64^2 crops in f32, focal
+ weighted loss (CE and dice + focal too), a global batch of 6 (3 rows a
rank at 2 ranks, 2 at 3; 12 for two micro-batches), its labels remade so
that the masked class 0 covers ~90 % of rank 0's rows and none of the
others' (the ranks' CE denominators differ several-fold).

Tolerances:
- A data-axis step against the one-process step on the same global batch:
  loss to 1e-5 relative and BatchNorm running statistics to 1e-5 of
  max(|ref|, 1) (measured ~3e-7 for both); the classifier's gradient, which
  f32 rounding alone moves, to 1e-4 in relative L2 (measured ~2e-7). Every
  other gradient to GRAD_RTOL = 5e-2 in relative L2 (a bias before a
  train-mode BatchNorm, whose gradient is rounding noise, to 1e-6 of all
  gradients' norm), and all of them together to 2.5e-2: the statistics of
  a train-mode BatchNorm over few values (2 x 2 x 6 at the deepest level)
  amplify f32 rounding, so that sums in another order move the stem's
  gradient by ~2.5 % (measured; the whole gradient by ~1e-3), as
  ``tests/test_torch_train.py`` measures for a 1e-7 perturbation and holds
  with the same bounds.
- Parameters across ranks after a step: bit for bit (every rank applies the
  same all-reduced gradients to the same parameters).
- Against ``s2tpu``'s trainer on a 2-device mesh (drop-connect keeping
  every sample, lr 1e-4): step 1's loss to 1e-5, step 2's to 1e-3, the
  bounds of ``tests/test_torch_train.py``'s JAX-held steps.
- An epoch from the device corpus at lr 1e-4, then the val pass: the val
  confusion matrix within 8 pixels (``tests/test_trainer.py:69``; measured
  2 of 9,044), its loss, the train loss and the metrics to 1e-3 (the update
  between the steps carries the gradient noise above into the weights).
  The same epoch in windows of 2 corpus steps: the ranks' training state
  (parameters, buffers, Adam) equals their one-step-at-a-time run's, bit
  for bit (eager steps on the CPU), and so holds the same bounds.
- BatchNorm recalibration from the same weights: the pooled statistics to
  1e-5 of max(|ref|, 1).
- A SIGTERM to one rank, then ``--auto-resume``: both ranks stop after the
  same step, and the final weights equal the uninterrupted run's to rtol
  1e-6 and atol 1e-7, as ``tests/test_torch_preemption.py`` holds one
  process.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.data.pipeline import Datamodule as JaxDatamodule
from s2tpu.parallel import mesh as jax_mesh
from s2tpu.parallel import multihost as jax_multihost
from s2tpu.train.trainer import SegmentationTrainer as JaxTrainer
from s2tpu_torch.checkpoint import io
from s2tpu_torch.checkpoint.convert import unet_state_dict_from_jax
from s2tpu_torch.data.pipeline import Datamodule
from s2tpu_torch.parallel import multihost
from s2tpu_torch.parallel.mesh import DataAxis
from tests.test_torch_multi_card import (  # noqa: F401 - dp_data_dir is a fixture
    DP_BATCH, DP_DIST, DP_EPOCH_LR, DP_STEPS, _dp_worker, assert_dp_step_close, assert_preempted_and_resumed,
    dp_config, dp_data_dir, dp_epoch, dp_global_batch, dp_ranks, dp_recal, dp_step, dp_trainer, join_ranks,
)

EPOCH_RTOL, CM_PIXELS = 1e-3, 8
SPAWN_TIMEOUT_S = 600  # a guard: the ranks take ~60 s alone, longer beside the suite's other workers
WORLDS = (2, 3)
# Accumulation and remat at 2 ranks; every loss type at 2 and 3.
SCENARIOS = {
    2: (*DP_STEPS, "jax", "corpus", "corpus_windows", "recal", "preempt", "refusals", "num_devices"),
    3: ("focal", "ce", "dice_focal", "num_devices"),
}
STEP_CASES = [(world, name) for world, names in SCENARIOS.items() for name in names if name in DP_STEPS]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch CPU threads for the one-process references: the ranks and
    the suite's other workers share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_config(data_dir):
    """``dp_config``'s run in the JAX package's config, on a 2-device mesh."""
    c = jax_cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = DP_BATCH
    c.datamodule.random_crop_size = 64
    c.train.compute_dtype = "float32"
    c.train.loss_type = c.train.loss_type.__class__("focal")
    c.train.weighted_loss = True
    c.train.class_distribution = list(DP_DIST)
    c.train.lr = 1e-4
    c.train.watch_interval = 0
    c.train.num_devices = 2
    return c


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dp_data_dir):
    """Every rank's records at 2 and 3 ranks (spawned together, while this
    process builds the references): the one-process steps, epoch and
    recalibration, and the JAX trainer's two steps on a 2-device mesh."""
    data_dir = str(dp_data_dir)
    tmp = {world: tmp_path_factory.mktemp(f"ranks{world}") for world in WORLDS}
    # The JAX trainer's init, carried to the ranks before they start.
    jcfg = _jax_config(dp_data_dir)
    jdm = JaxDatamodule(jcfg.datamodule, process_count=1, process_index=0)
    jtrainer = JaxTrainer(jcfg, jdm, mesh=jax_mesh.make_mesh(2))
    torch.save(unet_state_dict_from_jax(jax.device_get(jtrainer.state.params),
                                        jax.device_get(jtrainer.state.batch_stats)), tmp[2] / "jax_init.pt")
    contexts = {world: torch.multiprocessing.spawn(
        _dp_worker, args=(str(tmp[world]), data_dir, world, "gloo", "cpu", SCENARIOS[world], DP_BATCH),
        nprocs=world, join=False) for world in WORLDS}
    try:
        refs = {}
        for name, (loss, fields, batch) in DP_STEPS.items():
            refs[name] = dp_step(dp_trainer(data_dir, None, loss, batch or DP_BATCH, device="cpu", **fields),
                                 *dp_global_batch(data_dir, batch or DP_BATCH))
        refs["corpus"] = dp_epoch(dp_trainer(data_dir, None, device="cpu", device_corpus=True, lr=DP_EPOCH_LR))
        refs["recal"] = dp_recal(dp_trainer(data_dir, None, device="cpu"))
        images, labels = dp_global_batch(data_dir)
        sharding = jax_mesh.data_sharding(jtrainer.mesh)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.ones(shape, bool))
            state, jlosses = jtrainer.state, []
            for _ in range(2):
                state, out = jtrainer.train_step(state, jax.device_put(images, sharding),
                                                 jax.device_put(labels, sharding), jtrainer.base_rng)
                jlosses.append(float(out["loss"]))
        refs["jax"] = jlosses
    finally:
        for world, ctx in contexts.items():
            join_ranks(ctx, world, SPAWN_TIMEOUT_S, tmp[world])
    return {"refs": refs, "ranks": {world: dp_ranks(tmp[world], world) for world in WORLDS}, "tmp": tmp}


# ---------------------------------------------------------------------------
# no process group: the rows each process feeds
# ---------------------------------------------------------------------------
def test_local_slices_and_rows_match_the_jax_package():
    for bs, n in ((6, 2), (6, 3), (32, 4), (12, 1)):
        for i in range(n):
            assert multihost.local_slice(bs, n, i) == jax_multihost.local_slice(bs, n, i)
            np.testing.assert_array_equal(multihost.local_rows(bs, 1, n, i), np.arange(bs)[multihost.local_slice(bs, n, i)])
    # two micro-batches of 6 over 3 ranks: rank 1 takes rows 2-3 of each
    np.testing.assert_array_equal(multihost.local_rows(12, 2, 3, 1), [2, 3, 8, 9])
    with pytest.raises(AssertionError, match="must divide"):
        multihost.local_slice(6, 4, 0)


@pytest.mark.parametrize("world", WORLDS)
def test_datamodule_feeds_each_process_the_jax_package_rows(world, dp_data_dir):
    """Each process's train and padded eval batches are those of
    ``s2tpu``'s Datamodule for the same process (same seeds, same draws)."""
    jcfg = _jax_config(dp_data_dir)
    for rank in range(world):
        ours = Datamodule(dp_config(dp_data_dir).datamodule)
        ours.set_process(world, rank)
        theirs = JaxDatamodule(jcfg.datamodule, process_count=world, process_index=rank)
        for kind in ("train", "val"):
            a = list(ours.train_batches(1)) if kind == "train" else list(ours.eval_batches("val"))
            b = list(theirs.train_batches(1)) if kind == "train" else list(theirs.eval_batches("val"))
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                assert x.images.shape[0] == DP_BATCH // world * (1 if kind == "train" else 2)
                for field in ("images", "labels", "mask"):
                    np.testing.assert_array_equal(getattr(x, field), getattr(y, field))


def test_accumulating_ranks_take_their_slice_of_each_global_micro_batch(dp_data_dir):
    one = next(Datamodule(dp_config(dp_data_dir, batch=12).datamodule).train_batches(0))
    for rank in range(2):
        dm = Datamodule(dp_config(dp_data_dir, batch=12).datamodule)
        dm.set_process(2, rank, micro_batches=2)
        ours = next(dm.train_batches(0))
        for m, chunk in enumerate(np.split(ours.images, 2)):  # the rank's micro-batch m
            np.testing.assert_array_equal(chunk, one.images[m * 6 + rank * 3: m * 6 + rank * 3 + 3])
    with pytest.raises(ValueError, match="does not split"):
        Datamodule(dp_config(dp_data_dir).datamodule).set_process(2, 0, micro_batches=2)


def test_num_devices_without_a_process_group_raises_with_the_launch(dp_data_dir):
    with pytest.raises(RuntimeError, match="--num-devices 2.*torchrun --nproc-per-node 2"):
        dp_trainer(dp_data_dir, None, device="cpu", num_devices=2)


@pytest.mark.parametrize(
    "num_devices,cards,env,expected",
    [(-1, 2, {}, 2), (2, 2, {}, 2), (3, 2, {}, SystemExit), (0, 2, {}, SystemExit),
     (-1, 4, {"WORLD_SIZE": "3", "RANK": "0"}, 3), (2, 4, {"WORLD_SIZE": "3", "RANK": "0"}, SystemExit)],
)
def test_cli_ranks_are_the_visible_cards_or_the_launchers_world(num_devices, cards, env, expected, monkeypatch):
    """``--num-devices`` on the card: -1 takes every visible card (or a
    launcher's world size, which an explicit count must equal), and more
    than the visible cards is an error, never fewer ranks or the CPU."""
    from s2tpu_torch.parallel.multihost import num_ranks as _num_ranks

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for key in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if expected is SystemExit:
        with pytest.raises(SystemExit):
            _num_ranks(num_devices, torch.device("cuda"))
    else:
        assert _num_ranks(num_devices, torch.device("cuda")) == expected


def test_cli_ranks_on_the_cpu(monkeypatch):
    """With ``--device cpu`` the ranks are gloo processes: -1 is one."""
    from s2tpu_torch.parallel.multihost import num_ranks as _num_ranks

    for key in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert _num_ranks(-1, torch.device("cpu")) == 1 and _num_ranks(3, torch.device("cpu")) == 3


# ---------------------------------------------------------------------------
# N gloo ranks against one process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world,name", STEP_CASES)
def test_data_axis_step_equals_the_one_process_step(world, name, runs):
    assert all(rank["device"] == "cpu" for rank in runs["ranks"][world])
    assert_dp_step_close(runs["ranks"][world], name, runs["refs"][name])
    ref = runs["refs"][name]
    # each rank counts its own pixels; together, the global batch's
    cm = sum(rank[name]["cm"] for rank in runs["ranks"][world])
    assert float(cm.sum()) == float(ref["cm"].sum()) and float((cm - ref["cm"]).abs().sum()) <= CM_PIXELS


@pytest.mark.parametrize("world", WORLDS)
def test_parameters_are_bit_equal_across_ranks(world, runs):
    first, *others = runs["ranks"][world]
    for other in others:
        for name in (n for n in SCENARIOS[world] if n in DP_STEPS):
            assert other[name]["digest"] == first[name]["digest"], name  # parameters, gradients, statistics
            assert other[name]["loss"] == first[name]["loss"]


def test_two_rank_step_tracks_the_jax_trainer_on_a_two_device_mesh(runs):
    jlosses = runs["refs"]["jax"]
    for rank in runs["ranks"][2]:
        np.testing.assert_allclose(rank["jax"][0], jlosses[0], rtol=1e-5)
        np.testing.assert_allclose(rank["jax"][1], jlosses[1], rtol=1e-3)
    assert abs(jlosses[1] - jlosses[0]) > 1e-3 * jlosses[0]  # the update moved the model


def test_device_corpus_epoch_and_eval_match_one_process(runs):
    ref = runs["refs"]["corpus"]
    for rank in runs["ranks"][2]:
        ours = rank["corpus"]
        assert np.abs(ours["val_cm"] - ref["val_cm"]).sum() <= CM_PIXELS
        assert ours["val_cm"].sum() == ref["val_cm"].sum() > 0
        np.testing.assert_allclose(ours["train_loss"], ref["train_loss"], rtol=EPOCH_RTOL)
        np.testing.assert_allclose(ours["val"]["loss"], ref["val"]["loss"], rtol=EPOCH_RTOL)
        for k in ("iou", "accuracy", "f1"):
            assert abs(ours["val"][k] - ref["val"][k]) <= EPOCH_RTOL, k


def test_device_corpus_windows_on_a_data_axis_equal_single_steps(runs):
    """Windows of DP_WINDOW corpus steps on 2 ranks (eager on the CPU,
    gloo) train the state the same ranks train one step at a time, bit for
    bit, and so hold the one-process epoch to the same bounds."""
    ref = runs["refs"]["corpus"]
    for rank in runs["ranks"][2]:
        ours, single = rank["corpus_windows"], rank["corpus"]
        assert ours["digest"] == single["digest"] and ours["train_loss"] == single["train_loss"]
        assert np.abs(ours["val_cm"] - ref["val_cm"]).sum() <= CM_PIXELS
        np.testing.assert_allclose(ours["train_loss"], ref["train_loss"], rtol=EPOCH_RTOL)
        np.testing.assert_allclose(ours["val"]["loss"], ref["val"]["loss"], rtol=EPOCH_RTOL)


def test_bn_recalibration_pools_the_global_batches(runs):
    ref = runs["refs"]["recal"]
    for rank in runs["ranks"][2]:
        for n, s in ref.items():
            assert float(((rank["recal"][n] - s).abs() / s.abs().clamp_min(1.0)).max()) <= 1e-5, n


def test_sigterm_to_one_rank_stops_both_and_auto_resume_continues_exactly(runs):
    assert_preempted_and_resumed(runs["ranks"][2])
    # rank 0 alone wrote the runs: one log file each
    logs = sorted(os.path.basename(f) for f in glob.glob(str(runs["tmp"][2] / "logs" / "runs" / "*.metrics.jsonl")))
    assert logs == ["int_sentinel-segmentation.metrics.jsonl", "ref_sentinel-segmentation.metrics.jsonl"]


def test_refusals_on_a_data_axis(runs):
    for rank in runs["ranks"][2]:
        assert "num_devices=3, but the mesh's data axis holds 2 ranks" in rank["num_devices_refusal"]
    # A model axis above one rank, refused here until FSDP was ported (tests/test_torch_fsdp.py
    # trains it): a 1 x 2 mesh whose model ranks each hold their slices of B0's 24 sharded tensors
    assert [r["model_axis"] for r in runs["ranks"][2]] == [(1, 2, 0, 24), (1, 2, 1, 24)]


@pytest.mark.parametrize("world", WORLDS)
def test_num_devices_builds_the_data_axis_from_the_process_group(world, runs):
    assert [r["num_devices"] for r in runs["ranks"][world]] == [(world, i) for i in range(world)]


# ---------------------------------------------------------------------------
# the CLI starts its own ranks
# ---------------------------------------------------------------------------
def test_cli_trains_on_two_cpu_ranks_and_serves(dp_data_dir, tmp_path, monkeypatch):
    """``--num-devices 2 --device cpu`` outside a launcher spawns two gloo
    ranks; rank 0 writes the one run directory and log, which
    ``cli.infer --tiled`` serves."""
    from s2tpu_torch.cli.infer import main as infer_main
    from s2tpu_torch.cli.train_segmentation import main as train_main

    monkeypatch.setenv("S2TPU_ROOT", str(tmp_path))  # read by the spawned ranks
    history = train_main(["small", "osm-multiclass", "efficientnet-unet-b0", "--loss-type", "focal", "--weighted-loss",
                          "--bs", str(DP_BATCH), "--crop", "64", "--compute-dtype", "float32", "--epochs", "1",
                          "--data-dir", str(dp_data_dir), "--name", "dp", "--num-devices", "2", "--device", "cpu"])
    assert [r["epoch"] for r in history] == [0] and np.isfinite(history[0]["val/loss"])
    (run_dir,) = (tmp_path / "ckpts").glob("*/dp_*")
    assert io.epochs_in(run_dir) == [0]
    assert len(list((tmp_path / "logs" / "runs").glob("dp_*.metrics.jsonl"))) == 1
    config, _ = io.load_checkpoint(run_dir)
    assert config.train.num_devices == 2 and config.datamodule.batch_size == DP_BATCH
    out = infer_main([str(run_dir), "--tiled", "--device", "cpu", "--out", str(tmp_path / "preds"),
                      "--data-dir", str(dp_data_dir)])
    assert len(list(out.glob("pred_*.tif"))) == len(Datamodule(dp_config(dp_data_dir).datamodule).val_idx)


# ---------------------------------------------------------------------------
# graphed windows on a data axis: the rule and the persistent buckets
# ---------------------------------------------------------------------------
def test_gradient_buckets_are_persistent_flat_buffers_of_at_most_the_bucket_size():
    """``all_reduce_flat_``'s buckets: consecutive tensors up to the bucket
    size (a larger tensor alone), one flat buffer each, the same buffers at
    every call with the same shapes (the addresses a step graph captured)."""
    axis = DataAxis(None, 0, 2)
    tensors = [torch.zeros(n) for n in (10, 5, 40, 3, 3, 100, 1)]
    buckets = axis._flat_buffers(tensors, bucket_bytes=4 * 20)
    assert [[t.numel() for t in b] for b, _ in buckets] == [[10, 5], [40], [3, 3], [100], [1]]
    assert all(flat.numel() == sum(t.numel() for t in b) for b, flat in buckets)
    again = axis._flat_buffers([torch.ones(n) for n in (10, 5, 40, 3, 3, 100, 1)], bucket_bytes=4 * 20)
    assert all(a is b for (_, a), (_, b) in zip(buckets, again))
    assert axis._flat_buffers(tensors[:2], bucket_bytes=4 * 20)[0][1] is not buckets[0][1]  # other shapes


@pytest.mark.parametrize("backend,watched,graphed", [("nccl", False, True), ("gloo", False, False),
                                                     ("nccl", True, False)])
def test_corpus_windows_are_graphed_on_the_card_over_nccl_only(backend, watched, graphed, dp_data_dir, monkeypatch,
                                                                caplog):
    """The rule of ``TrainerBase._graphed`` on a card (the device set by
    hand here): windows above one step replay the step graph on a data axis
    of NCCL ranks; a gloo axis runs eager windows and says so once; watched
    norms make windows of one step."""
    from s2tpu_torch.train.trainer import SegmentationTrainer

    trainer = dp_trainer(dp_data_dir, None, device="cpu", device_corpus=True, steps_per_dispatch=4)
    monkeypatch.setattr(trainer, "device", torch.device("cuda"))
    monkeypatch.setattr(trainer, "data_axis", DataAxis(object(), 0, 2))
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group: backend)
    if watched:
        monkeypatch.setattr(trainer, "run_logger", object())
        trainer.config.train.watch_interval = 1
    with caplog.at_level("INFO"):
        assert [SegmentationTrainer._graphed(trainer) for _ in range(2)] == [graphed] * 2
    said = [r.message for r in caplog.records if "eager steps" in r.message or "disabled" in r.message]
    assert len(said) == (0 if graphed else 1)


def test_windows_follow_rank_zeros_watching_on_every_rank(dp_data_dir, monkeypatch):
    """Rank 0 alone holds the run logger; a rank without one whose peer
    watches norms (``TrainerBase._peer_logs``, learnt at construction) takes
    windows of one step too, so that no rank replays a step graph while
    another runs eager steps."""
    trainer = dp_trainer(dp_data_dir, None, device="cpu", device_corpus=True, steps_per_dispatch=4,
                         watch_interval=30)
    assert trainer.run_logger is None and not trainer._peer_logs and trainer._window_size() == 4
    monkeypatch.setattr(trainer, "_peer_logs", True)
    assert trainer._window_size() == 1
