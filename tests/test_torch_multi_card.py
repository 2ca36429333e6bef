"""s2tpu_torch's trainers with one rank per device: the tensor-parallel and data axes.

- Four gloo ranks on the CPU (``torch.multiprocessing.spawn``, a file://
  store): a (1, 4) mesh gives each rank one of the 4 heads and a quarter of
  the MLP hidden.
- ``cuda``-marked: two and four NCCL ranks on as many cards. ``make_mesh``
  binds each rank to its own card (``local_cuda_index``), and the trainer
  runs there: the tensor-parallel MAE step, the segmentation and MAE
  data-axis steps against one card, a SIGTERM over NCCL, and corpus
  windows graphed over NCCL against the same ranks' eager steps (B0 and a
  tiny MAE), bit for bit on each rank.

Each step is held to the one-process step on the same batch and noise
(f32, TF32 off on the card): loss to 1e-5 relative, each parameter gradient
to 1e-4 in relative L2 (the B0 data axis to the bounds stated at
``assert_dp_step_close``). Parameters and gradients across ranks: bit for
bit.

This file also holds the rank workers and helpers of
``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_data_parallel.py``
and ``tests/test_torch_mae_data_parallel.py``. It imports no JAX, so on a
machine with cards and without JAX the card tests run alone:
``python -m pytest --noconftest -m cuda tests/test_torch_multi_card.py``.
"""

import contextlib
import dataclasses
import hashlib
import multiprocessing.connection as mp_connection
import os
import pickle
import shutil
import signal
import time
import traceback

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
RANK_GRACE_S = 60  # after one rank fails, how long the others may take to end on their own


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


def join_ranks(ctx: mp.ProcessContext, world: int, timeout_s: float, tmp=None) -> None:
    """Wait for every rank of ``ctx`` to end. When one fails, the others get
    RANK_GRACE_S to end on their own (a rank whose peer died raises in its
    next collective); a rank still alive then, or at ``timeout_s``, is
    killed. Raises, naming every rank's exit code or signal and every
    traceback a rank left (``tmp/rank<r>.err``, else the spawn's error
    file), when any rank did not exit with 0."""
    t0, failed_at = time.time(), None
    procs = ctx.processes
    while any(p.is_alive() for p in procs):
        now = time.time()
        if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
            failed_at = now
        if now - t0 > timeout_s or (failed_at is not None and now - failed_at > RANK_GRACE_S):
            break
        mp_connection.wait([p.sentinel for p in procs if p.is_alive()], timeout=1)
    killed = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    if not any(killed) and all(p.exitcode == 0 for p in procs):
        return
    ends, tracebacks = [], []
    for r, (p, was_killed) in enumerate(zip(procs, killed)):
        code = p.exitcode
        end = f"signal {signal.Signals(-code).name}" if code < 0 else f"exit code {code}"
        ends.append(f"rank {r}: {end}" + (" (killed: still running)" if was_killed else ""))
        text = _rank_traceback(ctx.error_files[r], None if tmp is None else f"{tmp}/rank{r}.err")
        if text:
            tracebacks.append(f"-- rank {r}:\n{text}")
    why = f"did not finish within {timeout_s} s" if time.time() - t0 > timeout_s else "did not all succeed"
    raise RuntimeError(f"the {world} ranks {why}: {'; '.join(ends)}\n" + "\n".join(tracebacks))


def _rank_traceback(spawn_error_file: str, own: str | None) -> str:
    """The traceback a rank wrote itself (``own``), else the one
    ``torch.multiprocessing`` pickled for it; empty when there is none."""
    if own is not None and os.path.exists(own):
        with open(own) as f:
            return f.read()
    if os.path.exists(spawn_error_file) and os.path.getsize(spawn_error_file):
        with open(spawn_error_file, "rb") as f:
            return pickle.load(f)  # written by torch.multiprocessing in this test's own child
    return ""


def _spawn(worker, args: tuple, world: int, timeout_s: float, tmp=None) -> None:
    """Run ``worker(rank, *args)`` in ``world`` processes and
    :func:`join_ranks` them."""
    join_ranks(mp.spawn(worker, args=args, nprocs=world, join=False), world, timeout_s, tmp)


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
DP_WINDOW = 2  # corpus steps a window: the epoch's 2 steps in one window


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


def dp_trainer(data_dir, mesh=None, loss: str = "focal", batch: int = DP_BATCH, device=None,
               param_sharding: str = "replicated", run_logger=None, **train):
    """A SegmentationTrainer on ``data_dir``: one rank of ``mesh``, or one
    process on ``device``."""
    from s2tpu_torch.train.trainer import SegmentationTrainer

    cfg = dp_config(data_dir, loss, batch, **train)
    return SegmentationTrainer(cfg, Datamodule(cfg.datamodule), device=device, mesh=mesh,
                               param_sharding=param_sharding, run_logger=run_logger)


def batch_rows(trainer) -> np.ndarray | slice:
    """This rank's rows of a global batch: its data axis's share (every row
    on a model axis alone, or in one process)."""
    rows = trainer.dm.local_rows()
    return slice(None) if rows is None else rows


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
    rows = batch_rows(trainer)
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
            "val_cm": np.rint(counts), "digest": state_digest(trainer)}


def state_digest(trainer) -> str:
    """One hash of the trainer's parameters, buffers and Adam's state
    tensors: equal digests are equal training states, bit for bit."""
    params = [p for _, p in trainer.model.named_parameters()]
    adam = {f"adam.{i}.{k}": v for i, p in enumerate(params) for k, v in trainer.optimizer.state.get(p, {}).items()
            if isinstance(v, torch.Tensor)}
    return digest({**dict(trainer.model.named_parameters()), **dict(trainer.model.named_buffers()), **adam})


def whole_state_digest(trainer) -> str:
    """:func:`state_digest` of the whole training state: with sharded
    parameters (FSDP) the parameters and Adam's state tensors are gathered
    over the model axis first (a collective of every rank), so the ranks of
    a model group compare as the ranks of a data axis do, and an FSDP run
    as its replicated run."""
    if trainer.shards is None:
        return state_digest(trainer)
    state = trainer._checkpoint_state()
    order = {n: i for i, (n, _) in enumerate(trainer.model.named_parameters())}
    names = [n for n, _ in trainer._trainable()]  # the optimizer's parameters, in order
    params = {n: state["model"][n] for n in order}
    adam = {f"adam.{order[names[i]]}.{k}": v for i, st in state["optimizer"]["state"].items() for k, v in st.items()
            if isinstance(v, torch.Tensor)}
    return digest({**params, **dict(trainer.model.named_buffers()), **adam})


def dp_recal(trainer) -> dict:
    """The running statistics after BatchNorm recalibration over
    DP_RECAL_BATCHES train batches of epoch 0."""
    trainer.recalibrate_bn(DP_RECAL_BATCHES)
    return {n: b.detach().cpu().clone() for n, b in trainer.model.named_buffers() if "running" in n}


def dp_preempt_runs(data_dir, tmp: str, rank: int, device: str, batch: int) -> dict:
    """:func:`preempt_runs` of the segmentation CLI (B0, focal + weighted,
    64^2 crops, f32, an EMA)."""
    from s2tpu_torch.cli.train_segmentation import main
    from s2tpu_torch.train.trainer import SegmentationTrainer

    # On the card, cuDNN's default algorithms may sum a weight gradient in
    # another order each call; the resumed run must repeat the
    # uninterrupted run's arithmetic (as chip_smoke's preemption checks).
    torch.backends.cudnn.deterministic = True
    argv = ["small", "osm-multiclass", "efficientnet-unet-b0", "--loss-type", "focal", "--weighted-loss", "--bs",
            str(batch), "--crop", "64", "--compute-dtype", "float32", "--epochs", "1", "--data-dir", str(data_dir),
            "--device", device, "--ema-decay", "0.9", "--auto-resume"]
    return preempt_runs(tmp, rank, main, argv, SegmentationTrainer, "sentinel-segmentation")


def preempt_runs(tmp: str, rank: int, main, argv: list[str], trainer_cls, project: str) -> dict:
    """Three runs of a training CLI's ``main(argv)`` (one epoch of 2 steps,
    ``--auto-resume``) under the caller's process group: uninterrupted;
    stopped by a SIGTERM that only rank 1 receives, after its first step;
    the same command again. Returns the steps each rank trained in the
    stopped run, its history and the two runs' final checkpoints."""
    from pathlib import Path

    from s2tpu_torch.checkpoint.io import CheckpointManager, on_rank0
    from s2tpu_torch.configs import paths

    paths.CKPT_DIR, paths.LOG_DIR = Path(tmp) / "ckpts", Path(tmp) / "logs"
    main([*argv, "--name", "ref"])
    step, steps = trainer_cls.train_step, []

    def sigterm_on_rank1(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        steps.append(1)
        if rank == 1 and len(steps) == 1:
            signal.raise_signal(signal.SIGTERM)
        return out

    trainer_cls.train_step = sigterm_on_rank1
    try:
        stopped = main([*argv, "--name", "int"])
    finally:
        trainer_cls.train_step = step
    run = paths.CKPT_DIR / project / f"int_{project}"
    marker = CheckpointManager(run).restore_preempt()
    resumed = main([*argv, "--name", "int"])
    ref = CheckpointManager(paths.CKPT_DIR / project / f"ref_{project}").restore(0)
    got = CheckpointManager(run).restore(0)
    pending = CheckpointManager(run).has_preempt()
    # how far the resumed weights lie outside rtol 1e-6, atol 1e-7 of the uninterrupted run's (<= 0: inside)
    excess = {part: max(float(((got[part][n] - t).abs() - (1e-7 + 1e-6 * t.abs())).max()) for n, t in ref[part].items())
              for part in ("model", "ema")}
    # The runs' checkpoints, once every rank has read them: rank 0 removes
    # them only after this barrier (on_rank0's own barrier comes after its
    # write, so without this one a rank still reading would lose its files).
    dist.barrier()
    on_rank0(lambda: shutil.rmtree(paths.CKPT_DIR))
    return {"stopped_steps": len(steps), "stopped": stopped, "marker": {k: marker[k] for k in ("epoch",
            "batches_done", "step")}, "resumed": [r["epoch"] for r in resumed],
            "pending": pending, "steps": (got["step"], ref["step"]), "excess": excess}


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
        with traceback_file(tmp, rank):
            _dp_scenarios(rank, tmp, data_dir, world, device_type, scenarios, batch)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def traceback_file(tmp: str, rank: int):
    """This rank's traceback, when the block raises, in ``tmp/rank<rank>.err``
    (which :func:`join_ranks` reports beside every other rank's)."""
    try:
        yield
    except BaseException:
        with open(f"{tmp}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def _dp_scenarios(rank: int, tmp: str, data_dir: str, world: int, device_type: str, scenarios: tuple[str, ...],
                  batch: int) -> None:
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
        elif name == "corpus_windows":  # the same epoch in windows of DP_WINDOW steps
            out[name] = dp_epoch(dp_trainer(data_dir, mesh, batch=batch, device_corpus=True, lr=DP_EPOCH_LR,
                                            steps_per_dispatch=DP_WINDOW))
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
            # a model axis above one rank, refused here until FSDP was ported: the ranks shard B0
            t = dp_trainer(data_dir, mesh_lib.make_mesh(world, world, device_type=device_type), batch=batch,
                           param_sharding="fsdp")
            out["model_axis"] = (t.data_axis.size, t.model_axis.size, t.model_axis.index, len(t.shards.shards))
    torch.save(out, f"{tmp}/rank{rank}.pt")


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


# ---------------------------------------------------------------------------
# The MAE trainer's data axis (and data x model): one rank per process
# ---------------------------------------------------------------------------
# A tiny ViT (GEOMETRY: 64^2, patch 4, L = 256, mask 0.5, the fused route) at
# a global batch of 6 on dp_data_dir's 16 segments: split (0.75, 0.25) gives
# 12 train (an epoch of 2 steps) and 4 val (one eval batch of 12, padded).
DENSE = tm.PrithviConfig(**GEOMETRY)
MAE_DP_BATCH = 6


def mae_dp_config(data_dir, batch: int = MAE_DP_BATCH, stages: int = 1, **train):
    config = mae_cfg.base_config("small")
    config.model.pipeline_stages = stages
    config.datamodule.dataset_cfg.data_dir = str(data_dir)
    config.datamodule.batch_size = batch
    config.datamodule.random_crop_size = 64
    config.datamodule.data_split = (0.75, 0.25, 0.0)
    config.datamodule.augment = False
    config.model.mask_ratio = 0.5
    config.train.from_scratch = True
    config.train.lr = LR
    config.train.compute_dtype = "float32"
    config.train.watch_interval = 0
    for k, v in train.items():
        setattr(config.train, k, v)
    return config


def mae_dp_trainer(data_dir, mesh=None, model_config=DENSE, device=None, batch: int = MAE_DP_BATCH, stages: int = 1,
                   **train):
    """An MAETrainer on ``data_dir``'s images: one rank of ``mesh``, or one
    process on ``device``; ``stages`` pipeline stages over the mesh's model
    axis."""
    from s2tpu_torch.cli.train_mae import build_datamodule

    config = mae_dp_config(data_dir, batch, stages, **train)
    return MAETrainer(config, build_datamodule(config), mesh=mesh, model_config=model_config, device=device)


def mae_dp_global_batch(data_dir, batch: int = MAE_DP_BATCH) -> tuple[np.ndarray, torch.Tensor]:
    """The first global train batch of epoch 0 and seeded (B, L) masking
    noise for it."""
    from s2tpu_torch.cli.train_mae import build_datamodule

    images = next(build_datamodule(mae_dp_config(data_dir, batch)).train_batches(0)).images
    noise = np.random.default_rng(11).random((batch, DENSE.num_patches)).astype(np.float32)
    return images, torch.from_numpy(noise)


def mae_dp_step(trainer, images: np.ndarray, noise: torch.Tensor) -> dict:
    """One MAE step on this rank's rows of the global batch with the global
    noise: loss, gradients and digests (as :func:`dp_step`)."""
    m = trainer.train_step(put_batch(images, trainer.device, batch_rows(trainer)), noise=noise.to(trainer.device))
    grads = {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
    return {"loss": float(m["loss"]), "grads": grads,
            "digest": {"grads": digest(grads), "params": digest(dict(trainer.model.named_parameters()))}}


def mae_dp_epoch(trainer) -> dict:
    """One corpus epoch, then the val pass."""
    train = trainer.run_train_epoch(0)
    return {"train_loss": train["loss"], "val_loss": trainer.run_eval_epoch("val")["loss"],
            "digest": state_digest(trainer)}


def _tiny_mae_model_config(config):
    """The MAE CLI's model at test size (GEOMETRY's widths at the run's crop)."""
    return tm.PrithviConfig(**dict(GEOMETRY, img_size=config.datamodule.random_crop_size))


def mae_preempt_runs(data_dir, tmp: str, rank: int, device: str, world: int) -> dict:
    """:func:`preempt_runs` of the MAE CLI with ``--num-devices``, its model
    at test size (the default split gives 12 train segments: 2 steps)."""
    from s2tpu_torch.cli.train_mae import main
    from s2tpu_torch.train import mae_trainer

    mae_trainer.default_model_config = _tiny_mae_model_config
    argv = ["small", "--type", "pretrain", "--from-scratch", "--bs", str(MAE_DP_BATCH), "--crop", "64", "--epochs",
            "1", "--compute-dtype", "float32", "--data-dir", str(data_dir), "--device", device, "--ema-decay", "0.9",
            "--watch-interval", "0", "--num-devices", str(world), "--auto-resume"]
    return preempt_runs(tmp, rank, main, argv, MAETrainer, "prithvi-mae-finetune")


def _mae_dp_worker(rank: int, tmp: str, data_dir: str, world: int, model_parallel: int, backend: str,
                   device_type: str, scenarios: tuple[str, ...], batch: int = MAE_DP_BATCH) -> None:
    """One rank of the MAE's ('data', 'model') mesh: every scenario named,
    its record saved in ``tmp/rank<rank>.pt`` (a traceback in
    ``tmp/rank<rank>.err``)."""
    if device_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        with traceback_file(tmp, rank):
            _mae_dp_scenarios(rank, tmp, data_dir, world, model_parallel, device_type, scenarios, batch)
    finally:
        dist.destroy_process_group()


def _mae_dp_scenarios(rank: int, tmp: str, data_dir: str, world: int, model_parallel: int, device_type: str,
                      scenarios: tuple[str, ...], batch: int) -> None:
    mesh = mesh_lib.make_mesh(world, model_parallel, device_type=device_type)
    model_config = TP if model_parallel > 1 else DENSE
    images, noise = mae_dp_global_batch(data_dir, batch)
    out: dict = {}
    for name in scenarios:
        if name == "step":
            trainer = mae_dp_trainer(data_dir, mesh, model_config, batch=batch)
            out["device"] = str(trainer.device)
            out[name] = mae_dp_step(trainer, images, noise)
            if rank:
                del out[name]["grads"]
        elif name == "jax":  # the JAX trainer's init and its masking noise, two steps
            trainer = mae_dp_trainer(data_dir, mesh, model_config)
            trainer.model.load_state_dict(torch.load(f"{tmp}/jax_init.pt"), strict=True)
            out[name] = [mae_dp_step(trainer, images, n)["loss"] for n in torch.load(f"{tmp}/jax_noise.pt")]
        elif name == "corpus":  # the device corpus in windows of DP_WINDOW steps, with flips
            trainer = mae_dp_trainer(data_dir, mesh, model_config, device_corpus=True,
                                     steps_per_dispatch=DP_WINDOW)
            trainer.config.datamodule.augment = True
            out[name] = mae_dp_epoch(trainer)
        elif name == "preempt":
            out[name] = mae_preempt_runs(data_dir, tmp, rank, device_type, world)
        elif name == "num_devices":
            trainer = mae_dp_trainer(data_dir, None, model_config, device=device_type, num_devices=world)
            out[name] = (trainer.data_axis.size, trainer.data_axis.index)
    torch.save(out, f"{tmp}/rank{rank}.pt")


# A data-axis MAE step against the one-process step on the same global batch
# and noise (no BatchNorm: the ranks' partial sums differ from one sum by f32
# rounding alone): loss to 1e-5 relative, every gradient to GRAD_RTOL in
# relative L2; parameters and gradients bit-equal across the ranks.
def assert_mae_dp_step_close(ranks: list[dict], ref: dict) -> dict[str, float]:
    """The check above; returns the largest deviations measured."""
    for rank in ranks:
        assert rank["step"]["digest"] == ranks[0]["step"]["digest"] and rank["step"]["loss"] == ranks[0]["step"]["loss"]
    np.testing.assert_allclose(ranks[0]["step"]["loss"], float(ref["loss"]), rtol=1e-5)
    grads = ranks[0]["step"]["grads"]
    worst = max(_rel_l2(grads[n], g) for n, g in ref["grads"].items())
    assert set(grads) == set(ref["grads"]) and worst <= GRAD_RTOL, worst
    return {"loss": abs(ranks[0]["step"]["loss"] - float(ref["loss"])) / abs(float(ref["loss"])), "grads": worst}


def mae_one_process_step(data_dir, device: str = "cpu", batch: int = MAE_DP_BATCH) -> dict:
    """The one-process (one-card) MAE step the ranks are held to."""
    trainer = mae_dp_trainer(data_dir, None, DENSE, device=device, batch=batch)
    images, noise = mae_dp_global_batch(data_dir, batch)
    m = trainer.train_step(torch.from_numpy(images).to(trainer.device), noise=noise.to(trainer.device))
    return {"loss": float(m["loss"]), "grads": {n: p.grad.detach().cpu() for n, p in trainer.model.named_parameters()}}


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_mae_data_axis_step_on_one_card_per_rank(world, tmp_path, dp_data_dir):
    """The tiny MAE's step, 3 rows a rank, over ``world`` NCCL ranks, one
    card each, against the one-card f32 step on the same global batch."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} NVIDIA cards")
    batch = 3 * world
    _spawn(_mae_dp_worker, (str(tmp_path), str(dp_data_dir), world, 1, "nccl", "cuda", ("step",), batch), world,
           CARD_SPAWN_TIMEOUT_S, tmp_path)
    ranks = dp_ranks(tmp_path, world)
    assert [r["device"] for r in ranks] == [f"cuda:{r}" for r in range(world)]
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = mae_one_process_step(dp_data_dir, "cuda", batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    assert_mae_dp_step_close(ranks, ref)


# ---------------------------------------------------------------------------
# Graphed corpus windows over NCCL against eager windows (cards only)
# ---------------------------------------------------------------------------
# GRAPH_SEGMENTS give 25 train segments (split 0.8 / 0.75): 3 steps of
# GRAPH_BATCH, one window of 2 and a remainder step that replays the graph.
GRAPH_SEGMENTS, GRAPH_BATCH = 32, 8


def _graph_worker(rank: int, tmp: str, data_dir: str, world: int, model: str) -> None:
    """One NCCL rank: a corpus epoch graphed (windows of 2) and the same
    epoch eager (one step at a time) from the same init, each rank's final
    training state and epoch sums saved for the test."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the eager steps repeat the graph's convolution algorithms
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        with traceback_file(tmp, rank):
            _graph_epochs(rank, tmp, data_dir, world, model)
    finally:
        dist.destroy_process_group()


def _graph_epochs(rank: int, tmp: str, data_dir: str, world: int, model: str) -> None:
    # form: "" (a data axis), "fsdp" or "cp" (a model axis of 2), "pp<S>" (S pipeline stages on the model axis)
    base, _, form = model.partition("_")
    stages = int(form[2:]) if form.startswith("pp") else 1
    mesh = mesh_lib.make_mesh(world, stages if stages > 1 else 2 if form else 1, device_type="cuda")
    out = {}
    for mode, k in (("graphed", 2), ("eager", 1)):
        if base == "b0":
            trainer = dp_trainer(data_dir, mesh, batch=GRAPH_BATCH, device_corpus=True, steps_per_dispatch=k,
                                 param_sharding="fsdp" if form == "fsdp" else "replicated")
            train = trainer.run_train_epoch(0)
            sums = {"loss": train["loss"], "cm": trainer._sums["cm"].cpu()}
        else:
            config = PP if stages > 1 else CP if form == "cp" else DENSE
            trainer = mae_dp_trainer(data_dir, mesh, config, batch=GRAPH_BATCH, stages=stages, device_corpus=True,
                                     steps_per_dispatch=k)
            trainer.config.datamodule.augment = True  # the device flips
            sums = {"loss": trainer.run_train_epoch(0)["loss"]}
        out[mode] = {"digest": state_digest(trainer), "whole": whole_state_digest(trainer), "sums": sums,
                     "graph": trainer._graph is not None, "step": trainer.step}
    torch.save(out, f"{tmp}/rank{rank}.pt")


@pytest.fixture(scope="module")
def graph_data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("graph_data")
    make_synthetic_fixture(root, aoi="small", label_map="osm-multiclass", n_segments=GRAPH_SEGMENTS, size=(96, 96))
    return root


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["b0", "mae", "b0_fsdp", "mae_cp"])
@pytest.mark.parametrize("world", [2, 4])
def test_graphed_corpus_windows_over_nccl_equal_eager_steps_on_each_rank(world, model, tmp_path, graph_data_dir):
    """B0 (focal + weighted, BatchNorm sums in the graph) and the tiny MAE
    (device flips and masking noise drawn for the global batch) on a data
    axis, and on a model axis of 2 (B0 with FSDP: the all-gathers in the
    graph; the MAE with tp + cp: the token collectives and the token-share
    gradient bucket in the graph): an epoch of graphed windows on ``world``
    NCCL ranks trains, on each rank, the state and epoch sums of the same
    ranks' eager steps, bit for bit."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} NVIDIA cards")
    _spawn(_graph_worker, (str(tmp_path), str(graph_data_dir), world, model), world, CARD_SPAWN_TIMEOUT_S, tmp_path)
    ranks = dp_ranks(tmp_path, world)
    for rank in ranks:
        graphed, eager = rank["graphed"], rank["eager"]
        assert graphed["graph"] and not eager["graph"] and graphed["step"] == eager["step"] == 3
        assert graphed["digest"] == eager["digest"]
        assert all(torch.equal(torch.as_tensor(graphed["sums"][k]), torch.as_tensor(v)) for k, v in eager["sums"].items())
    assert len({r["graphed"]["whole"] for r in ranks}) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("world,stages", [(2, 2), (4, 2), (4, 4)])
def test_graphed_pipeline_windows_over_nccl_equal_eager_steps_on_each_rank(world, stages, tmp_path, graph_data_dir):
    """The tiny MAE with ``stages`` GPipe stages (PP: the encoder's 4 blocks
    one or two a stage, the decoder's 2 pipelined at 2 stages and whole at
    4) on a (world / stages) x stages NCCL mesh: the graph holds the
    rotation's and the copies' all-gathers and the stage-gradient bucket;
    an epoch of graphed windows trains each rank's eager state bit for bit,
    Adam's included, and every rank's state is the same."""
    test_graphed_corpus_windows_over_nccl_equal_eager_steps_on_each_rank(world, f"mae_pp{stages}", tmp_path,
                                                                           graph_data_dir)


# ---------------------------------------------------------------------------
# fc-prithvi on the data axis: one rank per process (a 2-block ViT, 64^2, f32)
# ---------------------------------------------------------------------------
# Narrow widths (embed 64, 4 heads, 2 encoder blocks, a head of 16), patch 16
# (a 4 x 4 token grid at 64^2), dropout FC_DROPOUT, on dp_data_dir's 16
# segments at DP_BATCH: 3 rows a rank at 2 ranks, 2 at 3.
FC_EMBED, FC_HEADS, FC_DEPTH, FC_HEAD_WIDTH, FC_DROPOUT = 64, 4, 2, 16, 0.1
FC_CLASSIFIER = "head.net.4.weight"  # conv, BatchNorm, ReLU, dropout, classifier


def fc_tiny_config(config, dropout: float = FC_DROPOUT):
    """The port's fc-prithvi config of ``config`` at test widths."""
    from s2tpu_torch.models.prithvi_seg import PrithviSegmentationConfig

    crop, t = config.datamodule.random_crop_size, config.datamodule.dataset_cfg.n_time_frames
    backbone = tm.PrithviConfig(img_size=crop, patch_size=16, num_frames=t, in_chans=6, embed_dim=FC_EMBED,
                                depth=FC_DEPTH, num_heads=FC_HEADS, decoder_embed_dim=48, decoder_depth=1,
                                decoder_num_heads=4, attention_impl="fused")
    return PrithviSegmentationConfig(num_frames=t, num_classes=config.num_classes, fcn_out_channels=FC_HEAD_WIDTH,
                                     fcn_num_convs=1, fcn_dropout=dropout,
                                     frozen_backbone=config.train.frozen_backbone, embed_dim=FC_EMBED,
                                     patch_height=crop // 16, patch_width=crop // 16, backbone=backbone)


@contextlib.contextmanager
def tiny_fc_prithvi(dropout: float = FC_DROPOUT):
    """fc-prithvi built at test widths while the block runs."""
    from s2tpu_torch.configs import segmentation as cfg_lib

    prev = cfg_lib.fc_prithvi_config
    cfg_lib.fc_prithvi_config = lambda config: fc_tiny_config(config, dropout)
    try:
        yield
    finally:
        cfg_lib.fc_prithvi_config = prev


def fc_dp_config(data_dir, batch: int = DP_BATCH, **train):
    """fc-prithvi's config at test size: 64^2 crops, f32, weighted CE, at
    DP_EPOCH_LR (the update between a frozen and an unfrozen step moves the
    bias before the head's BatchNorm by about lr on a sign that rounding
    picks, which the second step's statistics see: at 1e-3 by 1.5e-4)."""
    from s2tpu_torch.configs import segmentation as cfg_lib

    c = cfg_lib.base_config("fc-prithvi-backbone", aoi="small", label_map="osm-multiclass")
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = batch
    c.datamodule.random_crop_size = 64
    c.train.compute_dtype = "float32"
    c.train.weighted_loss = True
    c.train.class_distribution = list(DP_DIST)
    c.train.lr = DP_EPOCH_LR
    c.train.watch_interval = 0
    for k, v in train.items():
        setattr(c.train, k, v)
    return c


def fc_dp_trainer(data_dir, mesh=None, device=None, dropout: float = FC_DROPOUT, batch: int = DP_BATCH,
                  param_sharding: str = "replicated", **train):
    """An fc-prithvi SegmentationTrainer at test widths: one rank of
    ``mesh``, or one process on ``device``."""
    from s2tpu_torch.train.trainer import SegmentationTrainer

    cfg = fc_dp_config(data_dir, batch, **train)
    with tiny_fc_prithvi(dropout):
        return SegmentationTrainer(cfg, Datamodule(cfg.datamodule), device=device, mesh=mesh,
                                   param_sharding=param_sharding)


def fc_dp_global_batch(data_dir, batch: int = DP_BATCH) -> tuple[np.ndarray, np.ndarray]:
    """The first global train batch of epoch 0 of fc-prithvi's config."""
    b = next(Datamodule(fc_dp_config(data_dir, batch).datamodule).train_batches(0))
    return b.images, b.labels


def fc_dp_step(trainer, images: np.ndarray, labels: np.ndarray) -> dict:
    """One step on this rank's rows of the global batch: the loss, the
    gradients applied (the trainable parameters'), the head's BatchNorm
    running statistics, and digests of the gradients, parameters and
    statistics."""
    rows = batch_rows(trainer)
    m = trainer.train_step(*(put_batch(a, trainer.device, rows) for a in (images, labels)))
    grads = {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters() if p.grad is not None}
    stats = {n: b.detach().cpu().clone() for n, b in trainer.model.named_buffers() if "running" in n}
    return {"loss": float(m["loss"]), "grads": grads, "stats": stats,
            "digest": {"grads": digest(grads), "stats": digest(stats),
                       "params": digest(dict(trainer.model.named_parameters()))}}


def fc_frozen_then_unfrozen(trainer, images: np.ndarray, labels: np.ndarray) -> dict:
    """A frozen step, the unfreeze, an unfrozen step (on the same global
    batch), and the gradient buckets the data axis holds after them."""
    frozen = fc_dp_step(trainer, images, labels)
    trainer.unfreeze_backbone()
    unfrozen = fc_dp_step(trainer, images, labels)
    return {"frozen": frozen, "unfrozen": unfrozen, "buckets": len(trainer.data_axis._buckets)}


def _fc_dp_worker(rank: int, tmp: str, data_dir: str, world: int, scenarios: tuple[str, ...]) -> None:
    """One gloo rank of fc-prithvi's data axis: every scenario named, its
    record in ``tmp/rank<rank>.pt`` (a traceback in ``tmp/rank<rank>.err``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        with traceback_file(tmp, rank):
            mesh = mesh_lib.make_mesh(world, 1, device_type="cpu")
            images, labels = fc_dp_global_batch(data_dir)
            out: dict = {}
            for name in scenarios:
                if name == "fc":
                    out[name] = fc_frozen_then_unfrozen(fc_dp_trainer(data_dir, mesh), images, labels)
                    if rank:  # the test compares rank 0's gradients, the others' digests
                        for step in ("frozen", "unfrozen"):
                            del out[name][step]["grads"]
                elif name == "jax":  # the JAX trainer's init, dropout off, two frozen steps
                    trainer = fc_dp_trainer(data_dir, mesh, dropout=0.0, lr=1e-4)
                    init = torch.load(f"{tmp}/jax_init.pt")
                    trainer.model.load_state_dict(init["model"], strict=True)
                    trainer.mean, trainer.std = init["mean"], init["std"]
                    out[name] = [fc_dp_step(trainer, images, labels)["loss"] for _ in range(2)]
            torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# The running statistics after a second step (the unfrozen one) carry the
# first update's rounding: Adam moves the bias before the head's BatchNorm,
# whose gradient is rounding noise, by about lr on a sign the summation
# order picks, so the two runs' batch means may differ by 2 lr, of which the
# running mean takes 1 - decay (0.1).
FC_SECOND_STEP_STATS = 1e-5 + 2 * 0.1 * DP_EPOCH_LR


def assert_fc_dp_step_close(ranks: list[dict], name: str, ref: dict, stats_tol: float = 1e-5) -> None:
    """``assert_dp_step_close`` for an fc-prithvi step record (its
    classifier is the head's 1x1 conv; only trainable parameters have
    gradients; the running statistics to ``stats_tol``)."""
    first = ranks[0][name]
    for rank in ranks:
        assert rank[name]["digest"] == first["digest"] and rank[name]["loss"] == first["loss"]
        np.testing.assert_allclose(rank[name]["loss"], ref["loss"], rtol=1e-5)
        for n, s in ref["stats"].items():
            assert float(((rank[name]["stats"][n] - s).abs() / s.abs().clamp_min(1.0)).max()) <= stats_tol, n
    grads = first["grads"]
    assert set(grads) == set(ref["grads"])
    total = float(torch.cat([g.flatten() for g in ref["grads"].values()]).norm())
    assert _rel_l2(grads[FC_CLASSIFIER], ref["grads"][FC_CLASSIFIER]) <= DP_CLASSIFIER_GRAD_RTOL
    for n, g in ref["grads"].items():
        diff = float((grads[n] - g).norm())
        assert diff <= DP_GRAD_RTOL * float(g.norm()) + 1e-6 * total, (n, diff, float(g.norm()))
    ours = torch.cat([grads[n].flatten() for n in ref["grads"]])
    assert _rel_l2(ours, torch.cat([g.flatten() for g in ref["grads"].values()])) <= DP_TOTAL_GRAD_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_fc_prithvi_step_on_one_card_per_rank(world, tmp_path, dp_data_dir):
    """fc-prithvi's frozen and unfrozen steps (dropout 0.1, global batch of
    3 rows a rank) over ``world`` NCCL ranks, one card each, against the
    one-card steps (f32, TF32 off)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} NVIDIA cards")
    batch = 3 * world
    _spawn(_fc_card_worker, (str(tmp_path), str(dp_data_dir), world, batch), world, CARD_SPAWN_TIMEOUT_S, tmp_path)
    ranks = dp_ranks(tmp_path, world)
    assert [r["device"] for r in ranks] == [f"cuda:{r}" for r in range(world)]
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = fc_frozen_then_unfrozen(fc_dp_trainer(dp_data_dir, None, device="cuda", batch=batch),
                                      *fc_dp_global_batch(dp_data_dir, batch))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    assert_fc_dp_step_close([r["fc"] for r in ranks], "frozen", ref["frozen"])
    assert_fc_dp_step_close([r["fc"] for r in ranks], "unfrozen", ref["unfrozen"], FC_SECOND_STEP_STATS)


def _fc_card_worker(rank: int, tmp: str, data_dir: str, world: int, batch: int) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        with traceback_file(tmp, rank):
            trainer = fc_dp_trainer(data_dir, mesh_lib.make_mesh(world, 1, device_type="cuda"), batch=batch)
            out = {"device": str(trainer.device),
                   "fc": fc_frozen_then_unfrozen(trainer, *fc_dp_global_batch(data_dir, batch))}
            torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The sharded corpus: each rank holds its block of the segments
# ---------------------------------------------------------------------------
def sharded_seg_trainer(data_dir, mesh=None, device=None, **train):
    """B0's trainer (``dp_config``) from the sharded corpus, no flips (so
    that the JAX package's device flips, drawn from its own keys, stay out of
    the comparison), lr 1e-4."""
    from s2tpu_torch.train.trainer import SegmentationTrainer

    cfg = dp_config(data_dir, device_corpus=True, device_corpus_sharded=True, lr=DP_EPOCH_LR, **train)
    cfg.datamodule.augment = False
    return SegmentationTrainer(cfg, Datamodule(cfg.datamodule), device=device, mesh=mesh)


@contextlib.contextmanager
def every_sample_kept():
    """Drop-connect keeping every sample (the JAX package's masks come from
    its own keys)."""
    from s2tpu_torch.models import efficientnet_unet as tu

    draw = tu.drop_connect_mask
    tu.drop_connect_mask = lambda b, keep, generator, device: torch.ones(b, 1, 1, 1, dtype=torch.bool, device=device)
    try:
        yield
    finally:
        tu.drop_connect_mask = draw


def with_noise(trainer, noises: list[torch.Tensor]):
    """``trainer``'s MAE steps take ``noises[step]`` (the global batch's
    masking noise) instead of drawing their own."""
    step = trainer._step

    def noised(images, noise=None, flips=False):
        return step(images, noise=noises[trainer.step].to(trainer.device), flips=flips)

    trainer._step = noised
    return trainer


def _sharded_worker(rank: int, tmp: str, data_dir: str, world: int, scenarios: tuple[str, ...]) -> None:
    """One gloo rank training from the sharded corpus: every scenario named,
    its record in ``tmp/rank<rank>.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        with traceback_file(tmp, rank):
            mesh = mesh_lib.make_mesh(world, 1, device_type="cpu")
            out: dict = {}
            for name in scenarios:
                if name == "blocks":
                    corpus = sharded_seg_trainer(data_dir, mesh).corpus
                    out[name] = {"images": corpus.images, "labels": corpus.labels, "n_local": corpus.n_local,
                                 "sharded": corpus.sharded}
                elif name in ("seg_epoch", "seg_windows", "seg_recal"):
                    with every_sample_kept():
                        trainer = sharded_seg_trainer(data_dir, mesh,
                                                      steps_per_dispatch=2 if name == "seg_windows" else 1)
                        trainer.model.load_state_dict(torch.load(f"{tmp}/jax_seg_init.pt"), strict=True)
                        out[name] = dp_recal(trainer) if name == "seg_recal" else dp_epoch(trainer)
                elif name == "mae_epoch":
                    trainer = mae_dp_trainer(data_dir, mesh, DENSE, device_corpus=True, device_corpus_sharded=True)
                    trainer.model.load_state_dict(torch.load(f"{tmp}/jax_mae_init.pt"), strict=True)
                    with_noise(trainer, torch.load(f"{tmp}/jax_mae_noise.pt"))
                    out[name] = {"train_loss": trainer.run_train_epoch(0)["loss"], "steps": trainer.step,
                                 "images": trainer.corpus.images.shape, "labels": trainer.corpus.labels}
            torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# A model axis in the segmentation trainer: FSDP and replicated (B0 and
# fc-prithvi, 64^2, f32), and context parallelism in the MAE trainer
# ---------------------------------------------------------------------------
FSDP_STEPS, FSDP_LR = 3, 1e-4  # DP_EPOCH_LR: sums in other orders stay within the data axis's bounds


def whole_state(trainer) -> dict[str, torch.Tensor]:
    """The trainer's parameters and buffers, whole (sharded parameters
    gathered over the model axis: a collective of every rank), on the CPU."""
    model = trainer._checkpoint_state()["model"]
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    return {n: t.detach().cpu().clone() for n, t in state.items()}


def fsdp_steps(trainer, images: np.ndarray, labels: np.ndarray, n: int = FSDP_STEPS) -> dict:
    """``n`` steps on this rank's rows of the global batch: each step's loss
    and watch norms (names and values), the whole state after the first
    (of several) and after the last, and the last's digest."""
    rows = batch_rows(trainer)
    steps = []
    for i in range(n):
        m = trainer.train_step(*(put_batch(a, trainer.device, rows) for a in (images, labels)))
        names, values = m["watch"] if "watch" in m else ([], torch.zeros(0))
        steps.append({"loss": float(m["loss"]), "watch": dict(zip(names, values.cpu().tolist()))})
        if i == 0 and n > 1:
            first = whole_state(trainer)
    state = whole_state(trainer)
    return {"steps": steps, "state": state, "digest": digest(state), **({"state_1": first} if n > 1 else {})}


def fsdp_bytes(trainer) -> int:
    """The bytes of this rank's parameters, Adam's state, f32 master and
    EMA."""
    tensors = [*trainer.model.parameters(), *(v for st in trainer.optimizer.state.values() for v in st.values()
                                              if torch.is_tensor(v))]
    for part in (trainer.master, trainer.ema):
        if part is not None:
            tensors += list(part.state_dict().values())
    return sum(t.numel() * t.element_size() for t in tensors)


def fsdp_fit(trainer, directory) -> dict:
    """One epoch of ``trainer.fit`` with a checkpoint manager in
    ``directory``: the epoch's record and the checkpoint's whole model."""
    from s2tpu_torch.checkpoint.io import CheckpointManager

    trainer.ckpt = CheckpointManager(directory)
    record = trainer.fit(epochs=1)[0]
    return {"record": {k: v for k, v in record.items() if np.isscalar(v) and not k.endswith("per_sec")},
            "model": CheckpointManager(directory).restore(0)["model"]}


@contextlib.contextmanager
def no_drop_connect():
    """B0's drop-connect keeping every sample inside the block, as the JAX
    steps are run."""
    from s2tpu_torch.models import efficientnet_unet as tu

    draw = tu.drop_connect_mask
    tu.drop_connect_mask = lambda b, keep, generator, device: torch.ones(b, 1, 1, 1, dtype=torch.bool)
    try:
        yield
    finally:
        tu.drop_connect_mask = draw


def save_checkpoint(trainer, directory) -> None:
    """The trainer's state as epoch 0 of a run directory: whole tensors,
    gathered by every rank, written by rank 0."""
    from s2tpu_torch.checkpoint.io import CheckpointManager, on_rank0

    state = trainer._checkpoint_state()
    on_rank0(lambda: CheckpointManager(directory).save_epoch(0, step=trainer.step, **state))


def resumed(trainer, directory):
    """``trainer`` with epoch 0 of the run directory loaded."""
    from s2tpu_torch.checkpoint.io import CheckpointManager

    trainer.ckpt = CheckpointManager(directory)
    trainer.resume_from_checkpoint(0)
    return trainer


def _fsdp_worker(rank: int, tmp: str, data_dir: str, world: int, model_parallel: int, scenarios: tuple[str, ...],
                 backend: str = "gloo", device_type: str = "cpu") -> None:
    """One rank of a (world / model_parallel) x model_parallel mesh: every
    scenario named, its record in ``tmp/rank<rank>.pt``. Rank 0 keeps the
    whole states, the others their digests."""
    if device_type == "cpu":
        torch.set_num_threads(1)
    else:
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        with traceback_file(tmp, rank):
            out = _fsdp_scenarios(rank, tmp, data_dir, world, model_parallel, scenarios, device_type)
            if rank:
                for rec in out.values():
                    if isinstance(rec, dict):
                        rec.pop("state", None)
                        rec.pop("state_1", None)
            torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _fsdp_scenarios(rank: int, tmp: str, data_dir: str, world: int, model_parallel: int, scenarios, device_type):
    from s2tpu_torch.train.logging_utils import RunLogger

    mesh = mesh_lib.make_mesh(world, model_parallel, device_type=device_type)
    images, labels = dp_global_batch(data_dir)
    logger = RunLogger("fsdp", f"{tmp}/logs{rank}")  # only rank 0's is kept: every rank computes the norms
    out: dict = {}

    def trainer(sharding: str = "fsdp", on=mesh, **train):
        return dp_trainer(data_dir, on, lr=FSDP_LR, param_sharding=sharding, **train)

    for name in scenarios:
        if name == "jax":  # the JAX trainer's init, drop-connect keeping every sample
            with no_drop_connect():
                t, init = trainer(), torch.load(f"{tmp}/jax_init.pt")
                t.model.load_state_dict(t.shards.local(init), strict=True)  # this rank's slices
                out[name] = fsdp_steps(t, images, labels)
        elif name in ("fsdp", "replicated"):
            t = dp_trainer(data_dir, mesh, lr=FSDP_LR, param_sharding=name, run_logger=logger, watch_interval=1)
            out[name] = {**fsdp_steps(t, images, labels), "axes": (t.data_axis.size, t.model_axis.size),
                         "sharded": sorted(t.shards.shards) if t.shards is not None else [],
                         "whole_digest": whole_state_digest(t)}
            if name == "fsdp":
                fsdp = t
        elif name == "ckpt":  # checkpoints between FSDP, a data axis alone and one process, both ways
            save_checkpoint(fsdp, f"{tmp}/ckpt_fsdp")
            rec = {"fsdp_4": fsdp_steps(fsdp, images, labels, 1)}
            data = resumed(trainer("replicated", mesh_lib.make_mesh(world, 1, device_type=device_type)),
                           f"{tmp}/ckpt_fsdp")
            rec["data_4"] = fsdp_steps(data, images, labels, 1)
            save_checkpoint(data, f"{tmp}/ckpt_data")
            rec["data_5"] = fsdp_steps(data, images, labels, 1)
            rec["fsdp_5"] = fsdp_steps(resumed(trainer(), f"{tmp}/ckpt_data"), images, labels, 1)
            rec["from_one_4"] = fsdp_steps(resumed(trainer(), f"{tmp}/ckpt_one"), images, labels, 1)
            out[name] = rec
        elif name == "fc":  # fc-prithvi frozen, the unfreeze, unfrozen
            fc_images, fc_labels = fc_dp_global_batch(data_dir)
            t = fc_dp_trainer(data_dir, mesh, lr=FSDP_LR, param_sharding="fsdp")
            frozen = fsdp_steps(t, fc_images, fc_labels, 1)
            t.unfreeze_backbone()
            out[name] = {"frozen": frozen, "unfrozen": fsdp_steps(t, fc_images, fc_labels, 1),
                         "sharded": sorted(t.shards.shards)}
        elif name == "fit":  # an epoch through fit: steps, BatchNorm recalibration and eval on the EMA, a checkpoint
            out[name] = fsdp_fit(trainer(ema_decay=0.9, bn_recalibration_batches=1), f"{tmp}/fit_fsdp")
        elif name == "bytes":  # bf16 parameters with an f32 master and an EMA, after one step
            t = trainer(param_dtype="bfloat16", ema_decay=0.9)
            fsdp_steps(t, images, labels, 1)
            out[name] = fsdp_bytes(t)
    return out


# Context parallelism (a model axis of 2, the tokens split between the
# blocks): the tiny large-tile segmentation net's forward, the tiny MAE's
# forward and gradients (tp + cp, and cp alone), and MAETrainer steps.
CP_TILE = 64  # patch 16: 16 tokens and the cls token, 9 and 8 a rank (one pad row)
CP = tm.PrithviConfig(**GEOMETRY, tp_axis=mesh_lib.MODEL_AXIS, cp_axis=mesh_lib.MODEL_AXIS)
CP_STEPS = 3


def cp_seg_configs(cp: bool):
    """The port's tiny large-tile segmentation config of
    ``tests/test_context_parallel.py``'s ``_seg_for_tile`` at CP_TILE."""
    from s2tpu_torch.models import prithvi_seg as ts

    axes = dict(tp_axis=mesh_lib.MODEL_AXIS, cp_axis=mesh_lib.MODEL_AXIS) if cp else {}
    backbone = tm.PrithviConfig(img_size=CP_TILE, patch_size=16, num_frames=1, in_chans=6, embed_dim=64, depth=2,
                                num_heads=4, decoder_embed_dim=48, decoder_depth=1, decoder_num_heads=4,
                                attention_impl="fused", **axes)
    return ts.PrithviSegmentationConfig(num_frames=1, num_classes=4, frozen_backbone=False, embed_dim=64,
                                        patch_height=CP_TILE // 16, patch_width=CP_TILE // 16, backbone=backbone)


def cp_mae_run(model: tm.PrithviMAE, imgs: torch.Tensor, noise: torch.Tensor, ratio: float) -> dict:
    """A forward and backward of ``model``; the token-share gradients (as the
    trainer does) summed over the model axis. Also the first LayerNorm's
    gradient before that sum, this rank's tokens' share alone."""
    loss, pred, _ = model(imgs, mask_ratio=ratio, noise=noise)
    loss.backward()
    share = model.blocks[0].norm1.weight.grad.clone()
    shared = model.token_shard_parameters()
    if shared:
        model.context.all_reduce_flat_([p.grad for p in shared])
    return {"loss": loss.detach(), "pred": pred.detach(), "share": share,
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()}}


def cp_trainer_steps(trainer, images: np.ndarray, noises: list[torch.Tensor]) -> dict:
    """Steps of ``trainer`` with the given global masking noise: their
    losses, the first step's gradients, the parameters after the last."""
    rows, losses, grads = batch_rows(trainer), [], None
    for noise in noises:
        m = trainer.train_step(put_batch(images, trainer.device, rows), noise=noise.to(trainer.device))
        losses.append(float(m["loss"]))
        if grads is None:
            grads = {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
    params = {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
    return {"losses": losses, "grads": grads, "params": params, "digest": digest(params)}


def _cp_worker(rank: int, tmp: str, data_dir: str, world: int, scenarios: tuple[str, ...]) -> None:
    """One rank of a (world / 2) x 2 mesh: every scenario named, its record in
    ``tmp/rank<rank>.pt``; the inputs and initial weights come from the test
    process in ``tmp/cp_inputs.pt``."""
    from s2tpu_torch.models import prithvi_seg as ts

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        with traceback_file(tmp, rank):
            mesh = mesh_lib.make_mesh(world, 2, device_type="cpu")
            group = mesh.get_group(mesh_lib.MODEL_AXIS)
            given = torch.load(f"{tmp}/cp_inputs.pt", weights_only=False)
            out: dict = {}
            for name in scenarios:
                if name == "seg":
                    net = ts.PrithviSegmentationNet(cp_seg_configs(cp=True), tp_group=group)
                    net.load_state_dict(given["seg_state"], strict=True)
                    with torch.no_grad():
                        out[name] = net(given["seg_images"])
                elif name == "mae":
                    for form, config in given["mae_configs"].items():
                        model = tm.PrithviMAE(config, tp_group=group)
                        model.load_state_dict(given["mae_state"], strict=True)
                        out[form] = cp_mae_run(model, given["mae_images"], given["mae_noise"], given["mae_ratio"])
                elif name == "trainer":
                    trainer = mae_dp_trainer(data_dir, mesh, CP)
                    trainer.model.load_state_dict(given["trainer_state"], strict=True)
                    out[name] = cp_trainer_steps(trainer, given["trainer_images"], given["trainer_noise"])
            torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# GPipe over the model axis (PP: 4 encoder and 2 decoder blocks of the tiny
# ViT, so that 2 stages pipeline both stacks and 4 stages the encoder alone):
# the reference's tiny MAE (tests/test_pipeline_parallel.py's BASE) forward
# and backward on 1 x 2 and 1 x 4 meshes whose ranks hold every row, the
# MAETrainer on a 2 x 2 mesh, and the MAE CLI with --pp 2 on two ranks.
PP = tm.PrithviConfig(**dict(GEOMETRY, depth=4, decoder_depth=2))
PP_BATCH, PP_STEPS = 8, 2  # a global batch of 8: 4 rows a data rank of the 2 x 2 mesh, 2 a micro-batch
# the trainer extras beside the stages: each accumulation micro-batch's 2 rows a rank in 2 pipeline micro-batches
PP_EXTRAS = dict(remat=True, grad_accum_steps=2, ema_decay=0.9)
PP_BASE = dict(img_size=32, patch_size=8, num_frames=1, in_chans=6, embed_dim=64, depth=4, num_heads=4,
               decoder_embed_dim=48, decoder_depth=2, decoder_num_heads=4)


def pp_model(axis, microbatches: int, state: dict) -> tm.PrithviMAE:
    """The reference's tiny MAE in f32 with ``state``'s weights, its blocks
    pipelined over ``axis`` in ``microbatches`` micro-batches."""
    from s2tpu_torch.parallel.pipeline import Pipeline

    model = tm.PrithviMAE(tm.PrithviConfig(**PP_BASE), pipeline=Pipeline(axis, microbatches))
    model.load_state_dict(state, strict=True)
    return model


def pp_grads(model) -> dict[str, torch.Tensor]:
    """Every parameter's gradient after a backward of ``model`` (zeros where
    none reached it), the stages' block gradients summed over the model
    axis as the trainer sums them."""
    from s2tpu_torch.parallel.pipeline import pipeline_parameters

    grads = {n: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    stage_only = {id(p) for p in pipeline_parameters(model)}
    model.pipeline.axis.all_reduce_flat_([grads[n] for n, p in model.named_parameters() if id(p) in stage_only])
    return grads


def pp_scenario(name: str, m: int, axis, given: dict) -> dict:
    """One forward (and backward) of the tiny pipelined MAE on every row:
    ``encode`` (mask ratio 0), ``grads`` (the encoder against a cotangent),
    ``masked`` (the encoder at mask 0.5), ``decode`` (the reference's latent
    and ids), ``mae`` (the full forward, loss, gradients) and ``fallback``
    (the full forward where the stages do not divide the decoder)."""
    from s2tpu_torch.parallel import pipeline as pp

    model = pp_model(axis, m, given["state"])
    pipe, imgs = model.pipeline, given["imgs"]
    if name in ("encode", "grads", "masked"):
        ratio, noise = (0.5, given["noise"]["masked"]) if name == "masked" else (0.0, None)
        out, mask, ids = pp.prithvi_pipelined_encode(model, imgs, pipe, ratio, noise)
        if name != "grads":
            return {"out": out.detach(), "mask": mask, "ids": ids}
        (out * given["cot"]).sum().backward()
        return {"grads": pp_grads(model)}
    if name == "decode":
        with torch.no_grad():
            return {"pred": pp.prithvi_pipelined_decode(model, given["latent"], given["ids"], pipe)}
    loss, pred, mask = pp.prithvi_pipelined_mae_forward(model, imgs, pipe, 0.75, given["noise"][name])
    loss.backward()
    return {"loss": loss.detach(), "pred": pred.detach(), "mask": mask, "grads": pp_grads(model)}


def pp_trainer_steps(trainer, images: np.ndarray, noises: list[torch.Tensor]) -> dict:
    """:func:`cp_trainer_steps` with the parameters after the first step
    and a digest of the whole training state, Adam's included."""
    rows, losses, grads, first = batch_rows(trainer), [], None, None
    for noise in noises:
        m = trainer.train_step(put_batch(images, trainer.device, rows), noise=noise.to(trainer.device))
        losses.append(float(m["loss"]))
        if first is None:
            grads = {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
            first = {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
    return {"losses": losses, "grads": grads, "first": first, "digest": state_digest(trainer),
            "axes": (trainer.data_axis.size, trainer.model_axis.size)}


def pp_cli_run(data_dir, tmp: str, argv: list[str]) -> dict:
    """The MAE CLI's ``main(argv)`` with PP's widths at the run's crop, its
    run under ``tmp``: the history and the checkpoint's config."""
    from pathlib import Path

    from s2tpu_torch.checkpoint import io
    from s2tpu_torch.cli.train_mae import main
    from s2tpu_torch.configs import paths
    from s2tpu_torch.train import mae_trainer

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(mae_trainer, "default_model_config",
                      lambda config: dataclasses.replace(PP, img_size=config.datamodule.random_crop_size))
        patch.setattr(paths, "CKPT_DIR", Path(tmp) / "ckpts")
        patch.setattr(paths, "LOG_DIR", Path(tmp) / "logs")
        history = main(["small", "--type", "pretrain", "--from-scratch", "--bs", "4", "--crop", "64", "--epochs",
                        "1", "--compute-dtype", "float32", "--data-dir", str(data_dir), "--device", "cpu", "--wandb",
                        "--watch-interval", "0", "--seed", "3", *argv])
        (run,) = (paths.CKPT_DIR / "prithvi-mae-finetune").glob("*")
        return {"history": history, "model": dataclasses.asdict(io.load_mae_checkpoint(run)[0].model)}


def _pp_worker(rank: int, tmp: str, data_dir: str, world: int, scenarios: tuple) -> None:
    """One gloo rank: each scenario (name, micro-batches, stages) of
    :func:`pp_scenario` on a (world / stages) x stages mesh, ``("trainer",
    m, s)`` (MAETrainer steps), ``("extras", m, s)`` (with remat, gradient
    accumulation and the EMA), ``("corpus", m, s)`` (a sharded-corpus epoch
    with and without the stages) or ``("cli", m, s)``; the records in
    ``tmp/rank<rank>.pt``, the inputs from ``tmp/pp_inputs.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        with traceback_file(tmp, rank):
            given = torch.load(f"{tmp}/pp_inputs.pt", weights_only=False)
            meshes, out = {}, {}
            for name, m, stages in scenarios:
                if name == "cli":
                    out[name] = pp_cli_run(data_dir, tmp, ["--pp", str(stages), "--pp-microbatches", str(m),
                                                           "--num-devices", str(world)])
                    continue
                if stages not in meshes:
                    meshes[stages] = mesh_lib.make_mesh(world, stages, device_type="cpu")
                mesh = meshes[stages]
                if name in ("trainer", "extras"):
                    extras = PP_EXTRAS if name == "extras" else {}
                    trainer = mae_dp_trainer(data_dir, mesh, PP, batch=PP_BATCH, stages=stages, **extras)
                    trainer.model.load_state_dict(given["trainer_state"], strict=True)
                    out[name] = pp_trainer_steps(trainer, given["trainer_images"], given["trainer_noise"])
                elif name == "corpus":  # the sharded corpus in windows of DP_WINDOW steps, with flips
                    out[name] = {}
                    for form, s in (("pipeline", stages), ("dense", 1)):
                        trainer = mae_dp_trainer(data_dir, mesh, PP, batch=PP_BATCH, stages=s, device_corpus=True,
                                                 device_corpus_sharded=True, steps_per_dispatch=DP_WINDOW)
                        trainer.model.load_state_dict(given["trainer_state"], strict=True)
                        trainer.config.datamodule.augment = True
                        out[name][form] = mae_dp_epoch(trainer)
                else:
                    out[(name, m, stages)] = pp_scenario(name, m, mesh_lib.model_axis(mesh), given)
            torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
