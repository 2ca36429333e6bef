"""The data axis of s2tpu_torch's MAE trainer: N ranks, one process each, against one process and against the JAX package.

Ranks are gloo processes on the CPU (``torch.multiprocessing.spawn``, a
file:// store in a tmp dir, a spawn timeout), spawned once for the module at
2 and 3 ranks on a data axis and at 4 on a 2 x 2 ('data', 'model') mesh,
while this process builds the references; their records come back through
``torch.save``. The workers live in the JAX-free
``tests/test_torch_multi_card.py``, beside the NCCL card tests. A tiny ViT
(64^2, patch 4, L = 256, 2 + 1 blocks, the fused route's plain versions on
the CPU) in f32 at a global batch of 6 (3 rows a rank at 2 ranks and on the
2 x 2 mesh, 2 at 3).

Tolerances:
- A data-axis step against the one-process step on the same global batch
  and masking noise: loss to 1e-5 relative and every gradient to 1e-4 in
  relative L2. There is no BatchNorm, so only the order of f32 sums differs
  (measured: the loss equal, every gradient within 2.3e-7 at 2 and 3 ranks
  and on the 2 x 2 mesh).
- Parameters and gradients across ranks after a step: bit for bit.
- Against ``s2tpu``'s ``MAETrainer`` on ``make_mesh(2)`` and, tensor-parallel
  (``tp_axis="model"``), on ``make_mesh(4, model_parallel=2)``, from its init
  through the weight converter and with its masking noise passed in: step
  1's loss to 1e-5, step 2's to 1e-3 (the bounds of
  ``tests/test_torch_train.py``'s JAX-held steps; measured 1.1e-7 and
  8.9e-7).
- An epoch from the device corpus in windows of 2 steps, with device flips
  and masking noise drawn for the global batch, then the val pass (its
  padded rows differ per rank): the train and val losses to 1e-3 of the
  one-process epoch (the update between the steps carries f32 rounding into
  the weights; measured equal).
- The MAE CLI with ``--num-devices 2`` under the ranks' group, a SIGTERM to
  rank 1 alone, then ``--auto-resume``: both ranks stop after the same
  step, and the final weights and EMA equal the uninterrupted run's to rtol
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

from s2tpu.configs import mae as jax_mae_cfg
from s2tpu.configs.segmentation import DatamoduleConfig as JaxDatamoduleConfig
from s2tpu.configs.segmentation import DatasetConfig as JaxDatasetConfig
from s2tpu.data.dataset import TiffSource as JaxTiffSource
from s2tpu.data.pipeline import Datamodule as JaxDatamodule
from s2tpu.models.prithvi_mae import PrithviConfig as JaxPrithviConfig
from s2tpu.parallel import mesh as jax_mesh
from s2tpu.train.mae_trainer import MAETrainer as JaxMAETrainer
from s2tpu_torch.checkpoint.convert import prithvi_state_dict_from_jax
from tests.test_torch_multi_card import (  # noqa: F401 - dp_data_dir is a fixture
    DENSE, GEOMETRY, LR, MAE_DP_BATCH, TP, _mae_dp_worker, assert_mae_dp_step_close, assert_preempted_and_resumed,
    dp_data_dir, dp_ranks, join_ranks, mae_dp_config, mae_dp_epoch, mae_dp_global_batch, mae_dp_trainer,
    mae_one_process_step,
)

EPOCH_RTOL = 1e-3
SPAWN_TIMEOUT_S = 600  # a guard: the ranks take ~40 s alone, longer beside the suite's other workers
# world -> (model axis, scenarios)
WORLDS = {
    2: (1, ("step", "jax", "corpus", "preempt", "num_devices")),
    3: (1, ("step", "num_devices")),
    4: (2, ("step", "jax")),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch CPU threads for the one-process references: the ranks and
    the suite's other workers share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_trainer(data_dir, model_parallel: int) -> JaxMAETrainer:
    """``mae_dp_config``'s run in the JAX package on ``make_mesh(2)`` or,
    tensor-parallel, ``make_mesh(4, model_parallel=2)``."""
    c = jax_mae_cfg.base_config(aoi="small")
    ours = mae_dp_config(data_dir)
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = MAE_DP_BATCH
    c.datamodule.random_crop_size = 64
    c.datamodule.data_split = ours.datamodule.data_split
    c.datamodule.augment = False
    c.model.mask_ratio = ours.model.mask_ratio
    c.train.from_scratch = True
    c.train.lr = LR
    c.train.compute_dtype = "float32"
    dm = JaxDatamodule(
        JaxDatamoduleConfig(
            dataset_cfg=JaxDatasetConfig(aoi="small", label_map="osm-multiclass", data_dir=str(data_dir)),
            batch_size=MAE_DP_BATCH, data_split=c.datamodule.data_split, random_crop_size=64, augment=False,
        ),
        source=JaxTiffSource("small", "osm-multiclass", data_dir=data_dir, require_labels=False),
        process_count=1, process_index=0,
    )
    tp = {"tp_axis": "model"} if model_parallel > 1 else {}
    return JaxMAETrainer(c, dm, mesh=jax_mesh.make_mesh(2 * model_parallel, model_parallel=model_parallel),
                         model_config=JaxPrithviConfig(**GEOMETRY, **tp))


def _jax_noise(jt: JaxMAETrainer, step: int) -> np.ndarray:
    """The JAX step's masking noise: the step folded into the base key,
    split, drawn."""
    _, mask_key = jax.random.split(jax.random.fold_in(jt.base_rng, step))
    return np.array(jax.random.uniform(mask_key, (MAE_DP_BATCH, DENSE.num_patches)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dp_data_dir):
    """Every rank's records at 2, 3 and 4 (2 x 2) ranks, spawned together
    while this process builds the one-process references and runs the JAX
    trainer's two steps on both meshes."""
    data_dir = str(dp_data_dir)
    tmp = {world: tmp_path_factory.mktemp(f"mae_ranks{world}") for world in WORLDS}
    jax_trainers = {}
    for world, model_parallel in ((2, 1), (4, 2)):  # the JAX inits and noises, carried to the ranks first
        jt = jax_trainers[world] = _jax_trainer(dp_data_dir, model_parallel)
        config = TP if model_parallel > 1 else DENSE
        torch.save(prithvi_state_dict_from_jax(jax.device_get(jt.state.params), config), tmp[world] / "jax_init.pt")
        torch.save([torch.from_numpy(_jax_noise(jt, s)) for s in range(2)], tmp[world] / "jax_noise.pt")
    contexts = {world: torch.multiprocessing.spawn(
        _mae_dp_worker, args=(str(tmp[world]), data_dir, world, mp_, "gloo", "cpu", scenarios),
        nprocs=world, join=False) for world, (mp_, scenarios) in WORLDS.items()}
    try:
        refs = {"step": mae_one_process_step(data_dir)}
        one = mae_dp_trainer(data_dir, None, DENSE, device="cpu", device_corpus=True, steps_per_dispatch=2)
        one.config.datamodule.augment = True
        refs["corpus"] = mae_dp_epoch(one)
        images, _ = mae_dp_global_batch(data_dir)
        for world, jt in jax_trainers.items():
            state, losses = jt.state, []
            sharded = jax.device_put(jnp.asarray(images), jax_mesh.data_sharding(jt.mesh))
            for _ in range(2):
                state, out = jt.train_step(state, sharded, jt.base_rng)
                losses.append(float(out["loss"]))
            refs[f"jax{world}"] = losses
    finally:
        for world, ctx in contexts.items():
            join_ranks(ctx, world, SPAWN_TIMEOUT_S, tmp[world])
    return {"refs": refs, "ranks": {world: dp_ranks(tmp[world], world) for world in WORLDS}, "tmp": tmp}


@pytest.mark.parametrize("world", [2, 3])
def test_mae_data_axis_step_equals_the_one_process_step(world, runs):
    ranks = runs["ranks"][world]
    assert [r["device"] for r in ranks] == ["cpu"] * world
    assert_mae_dp_step_close(ranks, runs["refs"]["step"])


@pytest.mark.parametrize("world", [2, 3, 4])
def test_mae_parameters_and_gradients_are_bit_equal_across_ranks(world, runs):
    first, *others = runs["ranks"][world]
    for other in others:
        assert other["step"]["digest"] == first["step"]["digest"] and other["step"]["loss"] == first["step"]["loss"]


@pytest.mark.parametrize("world", [2, 4], ids=["data_mesh_2", "data_by_model_mesh_2x2"])
def test_mae_steps_track_the_jax_trainer_on_the_same_mesh(world, runs):
    """2 ranks against ``make_mesh(2)``; 2 x 2 (tensor-parallel heads and
    MLP over 'model') against ``make_mesh(4, model_parallel=2)``."""
    jlosses = runs["refs"][f"jax{world}"]
    for rank in runs["ranks"][world]:
        np.testing.assert_allclose(rank["jax"][0], jlosses[0], rtol=1e-5)
        np.testing.assert_allclose(rank["jax"][1], jlosses[1], rtol=1e-3)
    assert abs(jlosses[1] - jlosses[0]) > 1e-4 * jlosses[0]  # the update moved the model


def test_mae_data_by_model_step_equals_the_one_process_step(runs):
    """The 2 x 2 mesh's step (its own init, the seeded noise) against the
    dense one-process step: the tensor-parallel and dense models share
    parameters from one seed."""
    assert_mae_dp_step_close(runs["ranks"][4], runs["refs"]["step"])


def test_mae_device_corpus_windows_and_eval_match_one_process(runs):
    ref = runs["refs"]["corpus"]
    for rank in runs["ranks"][2]:
        ours = rank["corpus"]
        np.testing.assert_allclose(ours["train_loss"], ref["train_loss"], rtol=EPOCH_RTOL)
        np.testing.assert_allclose(ours["val_loss"], ref["val_loss"], rtol=EPOCH_RTOL)
        assert np.isfinite(ours["val_loss"]) and ours["digest"] == runs["ranks"][2][0]["corpus"]["digest"]


def test_mae_cli_sigterm_to_one_rank_stops_both_and_auto_resume_continues_exactly(runs):
    assert_preempted_and_resumed(runs["ranks"][2])
    logs = sorted(os.path.basename(f) for f in glob.glob(str(runs["tmp"][2] / "logs" / "runs" / "*.metrics.jsonl")))
    assert logs == ["int_prithvi-mae-finetune.metrics.jsonl", "ref_prithvi-mae-finetune.metrics.jsonl"]


@pytest.mark.parametrize("world", [2, 3])
def test_mae_num_devices_builds_the_data_axis_from_the_process_group(world, runs):
    assert [r["num_devices"] for r in runs["ranks"][world]] == [(world, i) for i in range(world)]


def test_mae_num_devices_without_a_process_group_raises_with_the_launch(dp_data_dir):
    with pytest.raises(RuntimeError, match="--num-devices 2.*torchrun --nproc-per-node 2 -m s2tpu_torch.cli.train_mae"):
        mae_dp_trainer(dp_data_dir, None, DENSE, device="cpu", num_devices=2)
