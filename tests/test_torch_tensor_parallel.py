"""The tensor-parallel Prithvi MAE of s2tpu_torch: against the JAX package's, against the dense port, and over two ranks.

- Without a process group, the port's tensor-parallel model (``tp_axis``
  set: head-major projections, kernels #6/#7's plain versions) against
  ``s2tpu``'s ``PrithviMAE(PrithviConfig(tp_axis="model"))`` under
  ``jax.set_mesh`` on a (1, 2) mesh (its heads split over two CPU devices,
  its Pallas #6/#7 in interpret mode), with the Flax parameters carried
  across by ``prithvi_state_dict_from_jax``. At img 64 / patch 4 the
  decoder (L = 257) takes the fused route; the encoder takes it at mask
  0.5 (L = 129) and plain attention at mask 0.75 (L = 65).
- The dense and tensor-parallel port models load each other's state dicts
  with ``strict=True`` and agree to f32 rounding.
- Two ranks over gloo (``torch.multiprocessing.spawn``, a file:// store): a
  (1, 2) mesh splits the 4 heads and the MLP hidden; its forward, one
  ``MAETrainer`` step (loss and gradients) and an epoch's checkpoints are
  held against the one-process run, and the parameters against each other
  across ranks.
- One rank per device (four gloo ranks, NCCL ranks on as many cards):
  ``tests/test_torch_multi_card.py``, which also holds the helpers shared
  with this file and imports no JAX.

Tolerances: f32 throughout, sums in other orders (JAX vs torch; the ranks'
partial sums vs one sum): loss to 1e-5 relative, predictions to 1e-4 of
their scale, each parameter gradient to 1e-4 in relative L2 (measured at
most ~6e-7, as in tests/test_torch_prithvi.py). Parameters across ranks:
bit for bit (every rank applies the same all-reduced gradients).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from s2tpu.models import prithvi_mae as jm
from s2tpu.parallel import mesh as jax_mesh
from s2tpu_torch.checkpoint.convert import prithvi_state_dict_from_jax
from s2tpu_torch.checkpoint.io import CheckpointManager, epochs_in
from s2tpu_torch.models import prithvi_mae as tm
from s2tpu_torch.ops import flash_attention as tfa
from s2tpu_torch.parallel import mesh as mesh_lib
from s2tpu_torch.train.logging_utils import RunLogger
from s2tpu_torch.parallel.pipeline import Pipeline
from s2tpu_torch.train.mae_trainer import MAETrainer
from tests.test_torch_multi_card import (
    GEOMETRY, GRAD_RTOL, SPAWN_TIMEOUT_S, TP, _inputs, _rel_l2, _single_step, _spawn, _step_record, _trainer_parts,
)

DENSE = tm.PrithviConfig(**GEOMETRY)
WORLD = 2


def _assert_close_run(a: dict, ref: dict) -> None:
    """Loss, predictions and every parameter gradient of two f32 runs."""
    np.testing.assert_allclose(float(a["loss"]), float(ref["loss"]), rtol=1e-5)
    scale = float(ref["pred"].abs().max())
    assert float((a["pred"] - ref["pred"]).abs().max()) <= 1e-4 * scale
    assert set(a["grads"]) == set(ref["grads"])
    for name, g in ref["grads"].items():
        assert _rel_l2(a["grads"][name], g) <= GRAD_RTOL, name


def _run(model: tm.PrithviMAE, imgs, noise, ratio: float) -> dict:
    loss, pred, _ = model(imgs, mask_ratio=ratio, noise=noise)
    loss.backward()
    return {"loss": loss.detach(), "pred": pred.detach(),
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()}}


# ---------------------------------------------------------------------------
# one process: against the JAX package and against the dense port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ratio,encoder_route", [(0.5, "fused"), (0.75, "plain")])
def test_tensor_parallel_model_matches_jax_on_a_two_device_mesh(ratio, encoder_route):
    l_enc = int(TP.num_patches * (1 - ratio)) + 1
    assert tfa.attention_route(l_enc, TP.embed_dim, TP.num_heads, "fused") == encoder_route
    assert tfa.attention_route(TP.num_patches + 1, TP.decoder_embed_dim, TP.decoder_num_heads, "fused") == "fused"
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(2, 1, 64, 64, 6)).astype(np.float32)
    key = jax.random.key(1)
    noise = np.array(jax.random.uniform(key, (2, TP.num_patches)))
    mesh = jax_mesh.make_mesh(2, model_parallel=2)
    with jax.set_mesh(mesh):
        model = jm.PrithviMAE(jm.PrithviConfig(**GEOMETRY, tp_axis="model"))
        params = jax.device_get(
            jax.jit(lambda: model.init(jax.random.key(0), jnp.zeros((1, 1, 64, 64, 6)), mask_ratio=0.0))()["params"]
        )

        def loss_fn(p):
            loss, pred, _ = model.apply({"params": p}, jnp.asarray(imgs), mask_ratio=ratio, mask_rng=key)
            return loss, pred

        (jloss, jpred), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax_mesh.replicate_pytree(params, mesh)
        )
    # The JAX tensor-parallel parameters (``_QKVEinsum``/``_ProjEinsum`` keep
    # nn.Dense's paths) convert with the dense mapping and load strict=True.
    port = tm.PrithviMAE(TP)
    port.load_state_dict(prithvi_state_dict_from_jax(params, TP), strict=True)
    assert isinstance(port.decoder_blocks[0].attn.qkv, tm.QKVEinsum)
    ours = _run(port, torch.from_numpy(imgs), torch.from_numpy(noise), ratio)
    grads = prithvi_state_dict_from_jax(jax.device_get(jgrads), TP)
    theirs = {"loss": torch.tensor(float(jloss)), "pred": torch.from_numpy(np.array(jpred)),
              "grads": {n: grads[n] for n in ours["grads"]}}
    _assert_close_run(ours, theirs)


@pytest.mark.parametrize("direction", ["dense into tensor-parallel", "tensor-parallel into dense"])
def test_dense_and_tensor_parallel_state_dicts_interchange(direction):
    src_cfg, dst_cfg = (DENSE, TP) if direction.startswith("dense") else (TP, DENSE)
    src = tm.PrithviMAE(src_cfg, generator=torch.Generator().manual_seed(3))
    dst = tm.PrithviMAE(dst_cfg, generator=torch.Generator().manual_seed(4))
    assert {k: v.shape for k, v in src.state_dict().items()} == {k: v.shape for k, v in dst.state_dict().items()}
    dst.load_state_dict(src.state_dict(), strict=True)
    imgs, noise = _inputs(5)
    for ratio in (0.5, 0.75):
        src.zero_grad(set_to_none=True)
        dst.zero_grad(set_to_none=True)
        _assert_close_run(_run(dst, imgs, noise, ratio), _run(src, imgs, noise, ratio))


def test_the_same_seed_gives_dense_and_tensor_parallel_models_the_same_parameters():
    dense = tm.PrithviMAE(DENSE, generator=torch.Generator().manual_seed(7)).state_dict()
    tp = tm.PrithviMAE(TP, generator=torch.Generator().manual_seed(7)).state_dict()
    assert all(torch.equal(dense[k], tp[k]) for k in dense)


def test_bf16_tensor_parallel_model_runs_with_f32_parameters():
    model = tm.PrithviMAE(TP, dtype=torch.bfloat16)
    imgs, noise = _inputs(6)
    loss, pred, _ = model(imgs.bfloat16(), mask_ratio=0.5, noise=noise)
    loss.backward()
    assert pred.dtype == torch.bfloat16 and torch.isfinite(loss)
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in model.parameters())


def test_context_parallelism_and_a_data_axis_are_refused():
    """Context parallelism and the sharded corpus, refused here until they
    were ported, build: without a model group a cp model is the dense one
    (the same parameters from one seed, the same loss and gradients), the
    MAE trainer takes ``cp_axis`` (tests/test_torch_context_parallel.py
    trains it on 1 x 2 and 2 x 2 meshes) and the sharded corpus
    (tests/test_torch_sharded_corpus.py), and pipeline stages train
    (tests/test_torch_pipeline_parallel.py). What stays refused: pipeline
    stages beside the tensor-parallel heads (both on the 'model' axis), a
    group for a model without a model axis, two model axes, and heads or
    tokens split over an axis other than 'model' (whose ranks would hold
    other rows)."""
    cp = dataclasses.replace(TP, cp_axis="model")
    imgs, noise = _inputs(5)
    ours = tm.PrithviMAE(cp, generator=torch.Generator().manual_seed(3))
    ref = tm.PrithviMAE(DENSE, generator=torch.Generator().manual_seed(3))
    assert ours.context is None and ours.token_shard_parameters() == []
    _assert_close_run(_run(ours, imgs, noise, 0.5), _run(ref, imgs, noise, 0.5))
    for config in (TP, cp):
        with pytest.raises(ValueError, match="pipeline parallelism and tensor/context parallelism both use the "
                                             "'model' axis"):
            tm.PrithviMAE(config, pipeline=Pipeline(mesh_lib.ModelAxis(None, 0, 2), 2))
    with pytest.raises(ValueError, match="tp_axis"):
        tm.PrithviMAE(DENSE, tp_group=object())
    with pytest.raises(ValueError, match="one model axis"):
        tm.PrithviMAE(dataclasses.replace(TP, cp_axis="data"))
    for axes in (dict(tp_axis=None, cp_axis="data"), dict(tp_axis="data"), dict(tp_axis="data", cp_axis="data")):
        with pytest.raises(ValueError, match="'model' axis only"):
            tm.PrithviMAE(dataclasses.replace(TP, **axes))


@pytest.mark.parametrize("dp_axis", [None, "model"])
def test_a_batch_axis_other_than_data_is_refused(dp_axis):
    with pytest.raises(NotImplementedError, match="dp_axis.*A16"):
        tm.PrithviMAE(dataclasses.replace(TP, dp_axis=dp_axis))


def test_make_mesh_needs_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_mesh(1, 1, device_type="cpu")


# ---------------------------------------------------------------------------
# two ranks over gloo
# ---------------------------------------------------------------------------
def _gloo_worker(rank: int, tmp: str, fixture_dir: str) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", world_size=WORLD, rank=rank)
    try:
        out: dict = {}
        config, dm = _trainer_parts(fixture_dir)
        sharded = dataclasses.replace(config, train=dataclasses.replace(config.train, device_corpus=True,
                                                                        device_corpus_sharded=True))
        # the MAE trainer's data axis trains from the sharded corpus: each rank holds its block
        corpus = MAETrainer(sharded, _trainer_parts(fixture_dir)[1], model_config=TP,
                            mesh=mesh_lib.make_mesh(WORLD, 1, device_type="cpu")).corpus
        out["data_axis_corpus"] = (corpus.sharded, corpus.n_local, corpus.images.shape[0], corpus.labels)
        mesh = mesh_lib.make_mesh(WORLD, WORLD, device_type="cpu")
        group = mesh.get_group(mesh_lib.MODEL_AXIS)
        try:
            tm.QKVEinsum(96, 3, torch.Generator().manual_seed(0), group)
        except ValueError as e:
            out["heads_refusal"] = str(e)

        # The forward and gradients of the sharded model, from rank 0's parameters.
        model = tm.PrithviMAE(TP, generator=torch.Generator().manual_seed(rank), tp_group=group)
        mesh_lib.replicate_module(model, mesh)
        out["replicated"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        imgs, noise = _inputs(0)
        out["forward"] = _run(model, imgs, noise, 0.5)
        # The same model with its tokens split over the group too (context
        # parallelism, refused here until it was ported): the forward.
        cp = tm.PrithviMAE(dataclasses.replace(TP, cp_axis="model"), tp_group=group)
        cp.load_state_dict(model.state_dict(), strict=True)
        with torch.no_grad():
            out["cp_forward"] = cp(imgs, mask_ratio=0.5, noise=noise)[:2]

        # One MAETrainer step on the mesh, then an epoch with a logger and checkpoints.
        trainer = MAETrainer(
            config, dm, mesh=mesh, model_config=TP, run_logger=RunLogger("run", f"{tmp}/logs{rank}"),
            checkpoint_manager=CheckpointManager(f"{tmp}/ckpt{rank}"),
        )
        out["device"] = str(trainer.device)
        images = torch.from_numpy(next(dm.train_batches(0)).images)
        m = trainer.train_step(images, noise=noise)
        out["step"] = _step_record(trainer, m["loss"])
        out["history"] = trainer.fit(epochs=1)
        out["fit_params"] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory, fixture_dir):
    """Both ranks' records, run once for this file's two-rank tests, and the
    one-process trainer step on the same batch and noise."""
    tmp = tmp_path_factory.mktemp("gloo")
    _spawn(_gloo_worker, (str(tmp), str(fixture_dir)), WORLD, SPAWN_TIMEOUT_S)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"tmp": tmp, "ranks": ranks, "single_step": _single_step(str(fixture_dir))}


def test_two_rank_forward_equals_the_one_process_model(gloo_run):
    one = tm.PrithviMAE(TP, generator=torch.Generator().manual_seed(0))
    imgs, noise = _inputs(0)
    ref = _run(one, imgs, noise, 0.5)
    for rank in gloo_run["ranks"]:
        # rank 1 was built from another seed: replicate_module made it rank 0's
        assert all(torch.equal(rank["replicated"][n], p) for n, p in one.named_parameters())
        _assert_close_run(rank["forward"], ref)
    a, b = (r["forward"] for r in gloo_run["ranks"])
    assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["pred"], b["pred"])


def test_two_rank_trainer_step_equals_the_one_process_step(gloo_run):
    ref = gloo_run["single_step"]
    for rank in gloo_run["ranks"]:
        assert rank["device"] == "cpu"
        np.testing.assert_allclose(float(rank["step"]["loss"]), float(ref["loss"]), rtol=1e-5)
        for name, g in ref["grads"].items():
            assert _rel_l2(rank["step"]["grads"][name], g) <= GRAD_RTOL, name


def test_parameters_stay_bit_identical_across_ranks(gloo_run):
    a, b = gloo_run["ranks"]
    for key in ("params", "grads"):
        assert all(torch.equal(a["step"][key][n], b["step"][key][n]) for n in a["step"][key])
    assert all(torch.equal(a["fit_params"][n], b["fit_params"][n]) for n in a["fit_params"])
    losses = [{k: v for k, v in r["history"][0].items() if "loss" in k} for r in (a, b)]
    assert losses[0] == losses[1] and all(np.isfinite(v) for v in losses[0].values())


def test_only_rank_zero_logs_and_writes_checkpoints(gloo_run):
    tmp = gloo_run["tmp"]
    assert epochs_in(tmp / "ckpt0") == [0] and epochs_in(tmp / "ckpt1") == []
    assert (tmp / "logs0" / "run.metrics.jsonl").exists() and not (tmp / "logs1" / "run.metrics.jsonl").exists()
    # the checkpoint is the published layout: the dense model loads it strict=True
    state = CheckpointManager(tmp / "ckpt0").restore(0)["model"]
    tm.PrithviMAE(DENSE).load_state_dict(state, strict=True)
    assert all(torch.equal(state[n], p) for n, p in gloo_run["ranks"][0]["fit_params"].items())


def test_two_rank_refusals(gloo_run):
    for rank in gloo_run["ranks"]:
        assert rank["data_axis_corpus"] == (True, 3, 3, None)  # 3 of the 6 segments, no labels
        assert "3 heads do not split over a model axis of 2 ranks" in rank["heads_refusal"]
        # context parallelism over the two ranks: the tensor-parallel forward, to this file's f32
        # tolerances (the gathered tokens' products may take other CPU kernels than the whole input's)
        loss, pred = rank["cp_forward"]
        np.testing.assert_allclose(float(loss), float(rank["forward"]["loss"]), rtol=1e-5)
        assert float((pred - rank["forward"]["pred"]).abs().max()) <= 1e-4 * float(rank["forward"]["pred"].abs().max())

