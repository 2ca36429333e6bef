"""The tensor-parallel ``MAETrainer`` step of s2tpu_torch with one rank per device.

- Four gloo ranks on the CPU (``torch.multiprocessing.spawn``, a file://
  store): a (1, 4) mesh gives each rank one of the 4 heads and a quarter of
  the MLP hidden.
- ``cuda``-marked: two and four NCCL ranks on as many cards. ``make_mesh``
  binds each rank to its own card (``local_cuda_index``), and the trainer
  runs there.

Each run is held to the one-process CPU step on the same batch and noise
(f32, TF32 off on the card): loss to 1e-5 relative, each parameter gradient
to 1e-4 in relative L2. Parameters and gradients across ranks: bit for bit.

This file imports no JAX, and neither do the helpers it shares with
``tests/test_torch_tensor_parallel.py``. So on a machine with cards and
without JAX the card tests run alone:
``python -m pytest --noconftest -m cuda tests/test_torch_multi_card.py``.
"""

import hashlib
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from s2tpu_torch.configs import mae as mae_cfg
from s2tpu_torch.configs.segmentation import DatamoduleConfig, DatasetConfig
from s2tpu_torch.data.dataset import TiffSource, make_synthetic_fixture
from s2tpu_torch.data.pipeline import Datamodule
from s2tpu_torch.models import prithvi_mae as tm
from s2tpu_torch.parallel import mesh as mesh_lib
from s2tpu_torch.parallel.multihost import put_batch
from s2tpu_torch.train.mae_trainer import MAETrainer

GEOMETRY = dict(img_size=64, patch_size=4, num_frames=1, tubelet_size=1, in_chans=6, embed_dim=128, depth=2,
                num_heads=4, decoder_embed_dim=128, decoder_depth=1, decoder_num_heads=4, attention_impl="fused")
TP = tm.PrithviConfig(**GEOMETRY, tp_axis=mesh_lib.MODEL_AXIS)
GRAD_RTOL = 1e-4
LR = 1e-3
SPAWN_TIMEOUT_S = 120
CARD_SPAWN_TIMEOUT_S = 600  # each rank loads the attention kernels, the first one builds them


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(seed: int = 0, batch: int = 2):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(batch, 1, 64, 64, 6)).astype(np.float32)
    noise = rng.random((batch, TP.num_patches)).astype(np.float32)
    return torch.from_numpy(imgs), torch.from_numpy(noise)


def _trainer_parts(fixture_dir: str):
    config = mae_cfg.base_config("small")
    config.datamodule.dataset_cfg.data_dir = fixture_dir
    config.datamodule.batch_size = 2
    config.datamodule.random_crop_size = 64
    config.datamodule.data_split = (0.5, 0.5, 0.0)
    config.datamodule.augment = False
    config.model.mask_ratio = 0.5
    config.train.from_scratch = True
    config.train.lr = LR
    config.train.watch_interval = 0  # norm watching off: the fit phases' run loggers record losses only
    dm = Datamodule(
        DatamoduleConfig(
            dataset_cfg=DatasetConfig(aoi="small", label_map="osm-multiclass", data_dir=fixture_dir),
            batch_size=2, data_split=(0.5, 0.5, 0.0), random_crop_size=64, augment=False,
        ),
        source=TiffSource("small", "osm-multiclass", data_dir=fixture_dir, require_labels=False),
    )
    return config, dm


def _step_record(trainer: MAETrainer, loss) -> dict:
    return {"loss": loss, "grads": {n: p.grad.clone() for n, p in trainer.model.named_parameters()},
            "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()}}


def _spawn(worker, args: tuple, world: int, timeout_s: float) -> None:
    """Run ``worker(rank, *args)`` in ``world`` processes; kill them all if
    they are not done within ``timeout_s``."""
    t0 = time.time()
    ctx = mp.spawn(worker, args=args, nprocs=world, join=False)
    try:
        while not ctx.join(timeout=1):
            if time.time() - t0 > timeout_s:
                raise TimeoutError(f"the {world} ranks did not finish within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _single_step(fixture_dir: str) -> dict:
    """The one-process CPU trainer step on the ranks' batch and noise."""
    config, dm = _trainer_parts(fixture_dir)
    single = MAETrainer(config, dm, model_config=TP, device="cpu")
    _, noise = _inputs(0)
    m = single.train_step(torch.from_numpy(next(dm.train_batches(0)).images), noise=noise)
    return _step_record(single, m["loss"])


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    make_synthetic_fixture(root, aoi="small", label_map="osm-multiclass", n_segments=6, size=(96, 96))
    return root


def _device_worker(rank: int, tmp: str, fixture_dir: str, world: int, backend: str, device_type: str) -> None:
    if device_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 products, to hold the CPU step
        torch.backends.cudnn.allow_tf32 = False
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        mesh = mesh_lib.make_mesh(world, world, device_type=device_type)
        config, dm = _trainer_parts(fixture_dir)
        trainer = MAETrainer(config, dm, mesh=mesh, model_config=TP)
        _, noise = _inputs(0)
        images = torch.from_numpy(next(dm.train_batches(0)).images)
        m = trainer.train_step(images.to(trainer.device), noise=noise.to(trainer.device))
        step = _step_record(trainer, m["loss"])
        step = {"loss": step["loss"].cpu(),
                **{k: {n: t.cpu() for n, t in step[k].items()} for k in ("grads", "params")}}
        torch.save({"device": str(trainer.device), "step": step}, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _check_one_rank_per_device(tmp, fixture_dir, world: int, device_type: str) -> None:
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
    expected = [f"cuda:{r}" for r in range(world)] if device_type == "cuda" else ["cpu"] * world
    assert [r["device"] for r in ranks] == expected
    ref = _single_step(str(fixture_dir))
    for rank in ranks:
        np.testing.assert_allclose(float(rank["step"]["loss"]), float(ref["loss"]), rtol=1e-5)
        for name, g in ref["grads"].items():
            assert _rel_l2(rank["step"]["grads"][name], g) <= GRAD_RTOL, name
    for other in ranks[1:]:
        for key in ("params", "grads"):
            assert all(torch.equal(other["step"][key][n], ranks[0]["step"][key][n]) for n in ranks[0]["step"][key])


def test_each_rank_takes_its_own_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 6)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert mesh_lib.local_cuda_index() == 2
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh_lib.local_cuda_index() == 3


def test_four_gloo_ranks_split_one_head_each(tmp_path, data_dir):
    _spawn(_device_worker, (str(tmp_path), str(data_dir), 4, "gloo", "cpu"), 4, SPAWN_TIMEOUT_S)
    _check_one_rank_per_device(tmp_path, data_dir, 4, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_tensor_parallel_step_on_one_card_per_rank(world, tmp_path, data_dir):
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} NVIDIA cards")
    _spawn(_device_worker, (str(tmp_path), str(data_dir), world, "nccl", "cuda"), world, CARD_SPAWN_TIMEOUT_S)
    _check_one_rank_per_device(tmp_path, data_dir, world, "cuda")


# ---------------------------------------------------------------------------
# The segmentation trainer's data axis: one rank per process (B0, 64^2, f32)
# ---------------------------------------------------------------------------
# The global batch of the CPU runs: 3 rows a rank at 2 ranks, 2 at 3; on the
# cards DP_CARD_BATCH, 6 a rank at 2 and 3 at 4. The fixture's 16 segments
# give 12 train (an epoch of 2 steps of 6) and 4 val (one eval batch of 12,
# padded).
DP_BATCH, DP_CARD_BATCH, DP_SEGMENTS = 6, 12, 16
DP_DIST = (0.1, 0.3, 0.4, 0.2)
# One step of each: the loss type, the config fields beside it and the
# global batch (None: the run's). Two micro-batches at 2 and 3 ranks need a
# global batch that 4 and 6 divide.
DP_STEPS = {
    "focal": ("focal", {}, None),
    "ce": ("ce", {}, None),
    "dice_focal": ("dice_focal", {}, None),
    "accum": ("focal", {"grad_accum_steps": 2}, 12),
    "remat": ("focal", {"remat": True}, None),
}
DP_RECAL_BATCHES = 2
# The epoch's learning rate. Adam's first steps move every parameter by about
# lr whatever its gradient's size, so a gradient that is rounding noise (a
# bias before a train-mode BatchNorm) moves by +-lr on a sign that the
# summation order picks; in eval mode that bias shifts the output. At 1e-4
# (tests/test_torch_train.py's JAX-held steps) the val predictions of two
# runs that sum in other orders stay within the JAX package's 8 pixels.
DP_EPOCH_LR = 1e-4


def dp_config(data_dir, loss: str = "focal", batch: int = DP_BATCH, **train):
    """Config #2's trainer at test size: B0, 64^2 crops, f32, weighted loss."""
    from s2tpu_torch.configs import segmentation as cfg_lib

    c = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = batch
    c.datamodule.random_crop_size = 64
    c.train.compute_dtype = "float32"
    c.train.loss_type = cfg_lib.LossType(loss)
    c.train.weighted_loss = True
    c.train.class_distribution = list(DP_DIST)
    c.train.lr = LR
    c.train.watch_interval = 0
    for k, v in train.items():
        setattr(c.train, k, v)
    return c


def dp_trainer(data_dir, mesh=None, loss: str = "focal", batch: int = DP_BATCH, device=None, **train):
    """A SegmentationTrainer on ``data_dir``: one rank of ``mesh``'s data
    axis, or one process on ``device``."""
    from s2tpu_torch.train.trainer import SegmentationTrainer

    cfg = dp_config(data_dir, loss, batch, **train)
    return SegmentationTrainer(cfg, Datamodule(cfg.datamodule), device=device, mesh=mesh)


def dp_global_batch(data_dir, batch: int = DP_BATCH) -> tuple[np.ndarray, np.ndarray]:
    """The first train batch of epoch 0, its labels remade so that the
    masked class 0 covers ~90 % of the first third of the rows (rank 0's
    slice) and none of the others: the ranks' CE denominators differ
    several-fold."""
    b = next(Datamodule(dp_config(data_dir, batch=batch).datamodule).train_batches(0))
    rng = np.random.default_rng(7)
    labels = b.labels.copy()
    k = batch // 3
    labels[:k] = np.where(rng.random(labels[:k].shape) < 0.9, 0, labels[:k])
    labels[k:] = np.where(labels[k:] == 0, rng.integers(1, 4, labels[k:].shape), labels[k:])
    return b.images, labels


def digest(tensors: dict[str, torch.Tensor]) -> str:
    """One hash of every tensor's bytes, in name order: equal digests are
    equal tensors, bit for bit."""
    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dp_step(trainer, images: np.ndarray, labels: np.ndarray) -> dict:
    """One train step of ``trainer`` on its rows of the global batch: the
    step's loss, confusion matrix, gradients (the ones applied) and
    BatchNorm running statistics on the CPU, and digests of the gradients,
    new parameters and statistics."""
    rows = trainer.dm.local_rows()
    m = trainer.train_step(*(put_batch(a, trainer.device, rows) for a in (images, labels)))
    grads = {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
    stats = {n: b.detach().cpu().clone() for n, b in trainer.model.named_buffers() if "running" in n}
    return {
        "loss": float(m["loss"]), "cm": m["cm"].cpu(), "grads": grads, "stats": stats,
        "digest": {"grads": digest(grads), "stats": digest(stats), "params": digest(dict(trainer.model.named_parameters()))},
    }


def dp_epoch(trainer) -> dict:
    """One epoch from the device corpus, then the val pass: the train
    loss and the val metrics with the confusion matrix in pixel counts."""
    train = trainer.run_train_epoch(0)
    val = trainer.run_eval_epoch("val")
    counts = np.asarray(val["confusion_matrix"]) * np.asarray(val["support"])[:, None]
    return {"train_loss": train["loss"], "val": {k: val[k] for k in ("loss", "iou", "accuracy", "f1")},
            "val_cm": np.rint(counts)}


def dp_recal(trainer) -> dict:
    """The running statistics after BatchNorm recalibration over
    DP_RECAL_BATCHES train batches of epoch 0."""
    trainer.recalibrate_bn(DP_RECAL_BATCHES)
    return {n: b.detach().cpu().clone() for n, b in trainer.model.named_buffers() if "running" in n}


def dp_preempt_runs(data_dir, tmp: str, rank: int, device: str, batch: int) -> dict:
    """Three training CLI runs of one epoch (2 steps) under the caller's
    process group: uninterrupted; stopped by a SIGTERM that only rank 1
    receives, after its first step; the same command again
    (``--auto-resume``). Returns the steps each rank trained in the
    stopped run, its history and the two runs' final checkpoints."""
    import signal
    from pathlib import Path

    from s2tpu_torch.checkpoint.io import CheckpointManager, on_rank0
    from s2tpu_torch.cli.train_segmentation import main
    from s2tpu_torch.configs import paths
    from s2tpu_torch.train.trainer import SegmentationTrainer

    paths.CKPT_DIR, paths.LOG_DIR = Path(tmp) / "ckpts", Path(tmp) / "logs"
    # On the card, cuDNN's default algorithms may sum a weight gradient in
    # another order each call; the resumed run must repeat the
    # uninterrupted run's arithmetic (as chip_smoke's preemption checks).
    torch.backends.cudnn.deterministic = True
    argv = ["small", "osm-multiclass", "efficientnet-unet-b0", "--loss-type", "focal", "--weighted-loss", "--bs",
            str(batch), "--crop", "64", "--compute-dtype", "float32", "--epochs", "1", "--data-dir", str(data_dir),
            "--device", device, "--ema-decay", "0.9", "--auto-resume"]
    main([*argv, "--name", "ref"])
    step, steps = SegmentationTrainer.train_step, []

    def sigterm_on_rank1(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        steps.append(1)
        if rank == 1 and len(steps) == 1:
            signal.raise_signal(signal.SIGTERM)
        return out

    SegmentationTrainer.train_step = sigterm_on_rank1
    try:
        stopped = main([*argv, "--name", "int"])
    finally:
        SegmentationTrainer.train_step = step
    run = paths.CKPT_DIR / "sentinel-segmentation" / "int_sentinel-segmentation"
    marker = CheckpointManager(run).restore_preempt()
    resumed = main([*argv, "--name", "int"])
    ref = CheckpointManager(paths.CKPT_DIR / "sentinel-segmentation" / "ref_sentinel-segmentation").restore(0)
    got = CheckpointManager(run).restore(0)
    # how far the resumed weights lie outside rtol 1e-6, atol 1e-7 of the uninterrupted run's (<= 0: inside)
    excess = {part: max(float(((got[part][n] - t).abs() - (1e-7 + 1e-6 * t.abs())).max()) for n, t in ref[part].items())
              for part in ("model", "ema")}
    on_rank0(lambda: shutil.rmtree(paths.CKPT_DIR))  # the runs' checkpoints, once read
    return {"stopped_steps": len(steps), "stopped": stopped, "marker": {k: marker[k] for k in ("epoch",
            "batches_done", "step")}, "resumed": [r["epoch"] for r in resumed],
            "pending": CheckpointManager(run).has_preempt(), "steps": (got["step"], ref["step"]), "excess": excess}


def _dp_worker(rank: int, tmp: str, data_dir: str, world: int, backend: str, device_type: str,
               scenarios: tuple[str, ...], batch: int) -> None:
    """One rank of the data axis: every scenario named, its record saved
    for the test process in ``tmp/rank<rank>.pt``."""
    if device_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 products, to hold the one-card step
        torch.backends.cudnn.allow_tf32 = False
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        mesh = mesh_lib.make_mesh(world, 1, device_type=device_type)
        images, labels = dp_global_batch(data_dir, batch)
        out: dict = {"device": None}
        for name in scenarios:
            if name in DP_STEPS:
                loss, fields, step_batch = DP_STEPS[name]
                trainer = dp_trainer(data_dir, mesh, loss, step_batch or batch, **fields)
                out["device"] = str(trainer.device)
                out[name] = dp_step(trainer, *dp_global_batch(data_dir, step_batch or batch))
                if rank:  # the test process compares rank 0's gradients, the others' digests
                    del out[name]["grads"]
            elif name == "jax":  # the JAX-held init, drop-connect keeping every sample, two steps
                from s2tpu_torch.models import efficientnet_unet as tu

                draw = tu.drop_connect_mask
                tu.drop_connect_mask = lambda b, keep, generator, device: torch.ones(b, 1, 1, 1, dtype=torch.bool)
                try:
                    trainer = dp_trainer(data_dir, mesh, batch=batch, lr=1e-4)
                    trainer.model.load_state_dict(torch.load(f"{tmp}/jax_init.pt"), strict=True)
                    out[name] = [dp_step(trainer, images, labels)["loss"] for _ in range(2)]
                finally:
                    tu.drop_connect_mask = draw
            elif name == "corpus":
                out[name] = dp_epoch(dp_trainer(data_dir, mesh, batch=batch, device_corpus=True, lr=DP_EPOCH_LR))
            elif name == "recal":
                out[name] = dp_recal(dp_trainer(data_dir, mesh, batch=batch))
            elif name == "preempt":
                out[name] = dp_preempt_runs(data_dir, tmp, rank, device_type, batch)
            elif name == "num_devices":  # the mesh built from train.num_devices and the process group
                trainer = dp_trainer(data_dir, None, batch=batch, device=device_type, num_devices=world)
                out[name] = (trainer.data_axis.size, trainer.data_axis.index)
            elif name == "refusals":
                try:
                    dp_trainer(data_dir, mesh, batch=batch, num_devices=world + 1)
                except ValueError as e:
                    out["num_devices_refusal"] = str(e)
                cfg = dp_config(data_dir, batch=batch)
                cfg.model_name = cfg.model_name.__class__("fc-prithvi-backbone")
                try:
                    from s2tpu_torch.train.trainer import SegmentationTrainer

                    SegmentationTrainer(cfg, None, mesh=mesh)
                except NotImplementedError as e:
                    out["prithvi_refusal"] = str(e)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_ranks(tmp, world: int) -> list[dict]:
    return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(world)]


# A data-axis step against the one-process step on the same global batch
# (tests/test_torch_data_parallel.py's docstring gives the measurements):
# loss to 1e-5 relative, BatchNorm running statistics to 1e-5 of max(|ref|,
# 1), the classifier's gradient (moved by f32 rounding alone) to 1e-4 in
# relative L2; every other gradient to 5e-2 (a bias before a train-mode
# BatchNorm, whose gradient is rounding noise, to 1e-6 of all gradients'
# norm) and all together to 2.5e-2: train-mode BatchNorm over few values
# amplifies sums in another order, as tests/test_torch_train.py measures.
DP_GRAD_RTOL, DP_TOTAL_GRAD_RTOL, DP_CLASSIFIER_GRAD_RTOL = 5e-2, 2.5e-2, 1e-4


def assert_dp_step_close(ranks: list[dict], name: str, ref: dict) -> None:
    """Every rank's step ``name`` against the one-process ``ref`` within
    the tolerances above; parameters, gradients and statistics equal bit for
    bit across the ranks (rank 0 alone records its gradients)."""
    for rank in ranks:
        step = rank[name]
        assert step["digest"] == ranks[0][name]["digest"] and step["loss"] == ranks[0][name]["loss"]
        np.testing.assert_allclose(step["loss"], ref["loss"], rtol=1e-5)
        for n, s in ref["stats"].items():
            assert float(((step["stats"][n] - s).abs() / s.abs().clamp_min(1.0)).max()) <= 1e-5, n
    grads = ranks[0][name]["grads"]
    assert set(grads) == set(ref["grads"])
    total = float(torch.cat([g.flatten() for g in ref["grads"].values()]).norm())
    assert _rel_l2(grads["out_conv1x1.weight"], ref["grads"]["out_conv1x1.weight"]) <= DP_CLASSIFIER_GRAD_RTOL
    for n, g in ref["grads"].items():
        diff = float((grads[n] - g).norm())
        assert diff <= DP_GRAD_RTOL * float(g.norm()) + 1e-6 * total, (n, diff, float(g.norm()))
    ours = torch.cat([grads[n].flatten() for n in ref["grads"]])
    assert _rel_l2(ours, torch.cat([g.flatten() for g in ref["grads"].values()])) <= DP_TOTAL_GRAD_RTOL


def assert_preempted_and_resumed(ranks: list[dict]) -> None:
    """A SIGTERM to rank 1 after its first step of two: every rank stopped
    there, the marker says so, the resumed run finished the epoch and its
    weights equal the uninterrupted run's to rtol 1e-6 and atol 1e-7 (as
    tests/test_torch_preemption.py holds one process)."""
    for rank in ranks:
        p = rank["preempt"]
        assert p["stopped_steps"] == 1 and p["stopped"] == []
        assert p["marker"] == {"epoch": 0, "batches_done": 1, "step": 1}
        assert p["resumed"] == [0] and not p["pending"] and p["steps"] == (2, 2)
        assert all(excess <= 0.0 for excess in p["excess"].values()), p["excess"]


@pytest.fixture(scope="module")
def dp_data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_data")
    make_synthetic_fixture(root, aoi="small", label_map="osm-multiclass", n_segments=DP_SEGMENTS, size=(96, 96))
    return root


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_data_axis_step_on_one_card_per_rank(world, tmp_path, dp_data_dir):
    """B0's step with its global batch over ``world`` NCCL ranks, one card
    each, against the one-card step (f32, TF32 off)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} NVIDIA cards")
    args = (str(tmp_path), str(dp_data_dir), world, "nccl", "cuda", ("focal",), DP_CARD_BATCH)
    _spawn(_dp_worker, args, world, CARD_SPAWN_TIMEOUT_S)
    ranks = dp_ranks(tmp_path, world)
    assert [r["device"] for r in ranks] == [f"cuda:{r}" for r in range(world)]
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = dp_step(dp_trainer(dp_data_dir, None, "focal", DP_CARD_BATCH, device="cuda"),
                      *dp_global_batch(dp_data_dir, DP_CARD_BATCH))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    assert_dp_step_close(ranks, "focal", ref)


@pytest.mark.cuda
def test_sigterm_to_one_rank_over_nccl_stops_both_and_resumes_exactly(tmp_path, dp_data_dir):
    """The preemption flag reduced over NCCL: the training CLI on two cards
    (B0, global batch 6), a SIGTERM to rank 1 alone, then --auto-resume."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 NVIDIA cards")
    _spawn(_dp_worker, (str(tmp_path), str(dp_data_dir), 2, "nccl", "cuda", ("preempt",), DP_BATCH), 2,
           CARD_SPAWN_TIMEOUT_S)
    assert_preempted_and_resumed(dp_ranks(tmp_path, 2))
