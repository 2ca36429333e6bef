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

import os
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
