"""Context parallelism in s2tpu_torch's Prithvi ViT: the tokens split over the model axis between the blocks.

Two gloo ranks on a 1 x 2 mesh and four on a 2 x 2 mesh (spawned once from a
module fixture; the rank worker lives in the JAX-free
``tests/test_torch_multi_card.py``), while this process runs the JAX
references on ``make_mesh(4, model_parallel=2)``. Every sequence here splits
unevenly over the two ranks of the model axis: 17 tokens (the large-tile
segmentation net at a 64^2 tile, patch 16), 5 encoder and 17 decoder tokens
(the MAE of ``tests/test_pipeline_parallel.py:24-26`` masked at 0.75), 129
and 257 (the trainer's MAE at mask 0.5).

- The non-slow analog of ``tests/test_context_parallel.py``: the
  segmentation net with tp + cp on 2 ranks against ``s2tpu``'s cp forward
  under ``jax.default_matmul_precision("highest")`` (rtol 1e-3, atol 1e-4,
  that test's bounds) and against the port's dense forward (1e-5 of the
  logits' scale: the ranks' sums of two partial products in f32); equal
  class maps.
- The MAE with tp + cp and with cp alone: loss and predictions against
  ``s2tpu``'s model on the same mesh from the same noise (loss 1e-5
  relative, predictions 1e-4 of their scale), and every parameter's
  gradient against ``jax.grad`` of ``s2tpu``'s dense model to 1e-4 in
  relative L2 (measured ~2e-6). A LayerNorm's gradient before the sum over
  the model axis is this rank's tokens' share alone, far from the whole.
- ``MAETrainer`` with ``PrithviConfig(tp_axis="model", cp_axis="model")``:
  three steps on 1 x 2 and 2 x 2 meshes from ``s2tpu``'s init and with its
  masking noise, against the port's one process (losses 1e-5 relative,
  step 1's gradients 1e-4 in relative L2, the parameters after three steps
  to 2.5 lr a step) and against ``s2tpu``'s ``MAETrainer`` on the same mesh
  (step 1's loss 1e-5, later 1e-3, as ``tests/test_torch_mae_data_parallel.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.models import prithvi_mae as jm
from s2tpu.parallel import mesh as jax_mesh
from s2tpu_torch.checkpoint.convert import prithvi_seg_state_dict_from_jax, prithvi_state_dict_from_jax
from s2tpu_torch.models import prithvi_mae as tm
from s2tpu_torch.models import prithvi_seg as ts
from tests.test_context_parallel import _seg_for_tile
from tests import test_torch_mae_data_parallel as mae_dp_tests
from tests.test_torch_mae_data_parallel import _jax_noise, _jax_trainer
from tests.test_torch_multi_card import (  # noqa: F401 - dp_data_dir is a fixture
    CP, CP_STEPS, CP_TILE, DENSE, GRAD_RTOL, LR, _cp_worker, _rel_l2, cp_seg_configs, cp_trainer_steps, dp_data_dir,
    dp_ranks, join_ranks, mae_dp_global_batch, mae_dp_trainer,
)
from tests.test_torch_tensor_parallel import _assert_close_run

SPAWN_TIMEOUT_S = 600  # a guard: the ranks take ~15 s alone, longer beside the suite's other workers
MAE = dict(img_size=32, patch_size=8, num_frames=1, in_chans=6, embed_dim=64, depth=4, num_heads=4,
           decoder_embed_dim=48, decoder_depth=2, decoder_num_heads=4)
RATIO = 0.75
FORMS = {"tp_cp": dict(tp_axis="model", cp_axis="model"), "cp": dict(cp_axis="model")}
WORLDS = {2: ("seg", "mae", "trainer"), 4: ("trainer",)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _seg_reference(seg_images: np.ndarray) -> dict:
    """``s2tpu``'s large-tile net: its weights, the dense forward and the
    tp + cp forward on ``make_mesh(4, model_parallel=2)``."""
    plain = _seg_for_tile(CP_TILE, cp=False)
    x = jnp.asarray(seg_images)
    variables = jax.jit(lambda: plain.init(jax.random.key(0), x[:1], train=False))()
    with jax.default_matmul_precision("highest"):
        mesh = jax_mesh.make_mesh(4, model_parallel=2)
        with jax.set_mesh(mesh):
            cp_model = _seg_for_tile(CP_TILE, cp=True)
            out = jax.jit(lambda v, x: cp_model.apply(v, x, train=False))(
                jax_mesh.replicate_pytree(variables, mesh), jax.device_put(x, jax_mesh.data_sharding(mesh)))
    variables = jax.device_get(variables)
    state = prithvi_seg_state_dict_from_jax(variables["params"], variables["batch_stats"],
                                            cp_seg_configs(cp=False).backbone)
    return {"state": state, "logits": np.asarray(out)}


def _mae_reference(imgs: np.ndarray, key) -> dict:
    """``s2tpu``'s tiny MAE: its weights, the dense model's gradients, and
    each cp form's loss and predictions on ``make_mesh(4, model_parallel=2)``."""
    dense = jm.PrithviMAE(jm.PrithviConfig(**MAE))
    params = jax.device_get(jax.jit(lambda: dense.init(jax.random.key(0), jnp.zeros((1, 1, 32, 32, 6)),
                                                       mask_ratio=0.0))()["params"])

    def value_and_grad(model, p):
        def loss_fn(p):
            loss, pred, _ = model.apply({"params": p}, jnp.asarray(imgs), mask_ratio=RATIO, mask_rng=key)
            return loss, pred

        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p)

    (loss, pred), grads = value_and_grad(dense, params)
    config = tm.PrithviConfig(**MAE, attention_impl="fused")
    out = {"params": params, "dense": {"loss": torch.tensor(float(loss)), "pred": torch.from_numpy(np.array(pred)),
                                       "grads": {n: g for n, g in prithvi_state_dict_from_jax(
                                           jax.device_get(grads), config).items() if n not in tm.PrithviMAE.POS_KEYS}}}
    mesh = jax_mesh.make_mesh(4, model_parallel=2)
    for form, axes in FORMS.items():
        with jax.set_mesh(mesh):
            (loss, pred), _ = value_and_grad(jm.PrithviMAE(jm.PrithviConfig(**MAE, **axes)),
                                             jax_mesh.replicate_pytree(params, mesh))
        out[form] = {"loss": torch.tensor(float(loss)), "pred": torch.from_numpy(np.array(pred))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dp_data_dir):
    data_dir = str(dp_data_dir)
    tmp = {world: tmp_path_factory.mktemp(f"cp{world}") for world in WORLDS}
    rng = np.random.default_rng(0)
    seg_images = rng.normal(size=(2, 1, CP_TILE, CP_TILE, 6)).astype(np.float32)
    mae_images = rng.normal(size=(2, 1, 32, 32, 6)).astype(np.float32)
    key = jax.random.key(1)
    noise = np.array(jax.random.uniform(key, (2, tm.PrithviConfig(**MAE).num_patches)))
    seg = _seg_reference(seg_images)
    mae = _mae_reference(mae_images, key)
    jt = _jax_trainer_cp(dp_data_dir)
    trainer_state = prithvi_state_dict_from_jax(jax.device_get(jt.state.params), DENSE)
    noises = [torch.from_numpy(_jax_noise(jt, step)) for step in range(CP_STEPS)]
    images, _ = mae_dp_global_batch(dp_data_dir)
    given = {
        "seg_state": seg["state"], "seg_images": torch.from_numpy(seg_images),
        "mae_configs": {form: tm.PrithviConfig(**MAE, attention_impl="fused", **axes) for form, axes in FORMS.items()},
        "mae_state": prithvi_state_dict_from_jax(mae["params"], tm.PrithviConfig(**MAE)),
        "mae_images": torch.from_numpy(mae_images), "mae_noise": torch.from_numpy(noise), "mae_ratio": RATIO,
        "trainer_state": trainer_state, "trainer_images": images, "trainer_noise": noises,
    }
    for world in WORLDS:
        torch.save(given, tmp[world] / "cp_inputs.pt")
    contexts = {world: torch.multiprocessing.spawn(_cp_worker, args=(str(tmp[world]), data_dir, world, scenarios),
                                                   nprocs=world, join=False) for world, scenarios in WORLDS.items()}
    try:
        dense_seg = ts.PrithviSegmentationNet(cp_seg_configs(cp=False))
        dense_seg.load_state_dict(seg["state"], strict=True)
        with torch.no_grad():
            dense_logits = dense_seg(given["seg_images"])
        one = mae_dp_trainer(data_dir, None, DENSE, device="cpu")
        one.model.load_state_dict(trainer_state, strict=True)
        one_steps = cp_trainer_steps(one, images, noises)
        jax_losses, state = [], jt.state
        sharded = jax.device_put(jnp.asarray(images), jax_mesh.data_sharding(jt.mesh))
        for _ in range(CP_STEPS):
            state, m = jt.train_step(state, sharded, jt.base_rng)
            jax_losses.append(float(m["loss"]))
    finally:
        for world, ctx in contexts.items():
            join_ranks(ctx, world, SPAWN_TIMEOUT_S, tmp[world])
    return {"ranks": {world: dp_ranks(tmp[world], world) for world in WORLDS}, "seg": seg,
            "dense_logits": dense_logits, "mae": mae, "one_steps": one_steps, "jax_losses": jax_losses}


def _jax_trainer_cp(data_dir):
    """``s2tpu``'s MAETrainer of ``tests/test_torch_mae_data_parallel.py`` on
    ``make_mesh(4, model_parallel=2)`` with ``tp_axis`` and ``cp_axis``."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(mae_dp_tests, "JaxPrithviConfig", functools.partial(mae_dp_tests.JaxPrithviConfig, cp_axis="model"))
        return _jax_trainer(data_dir, 2)


def test_large_tile_segmentation_matches_s2tpus_cp_forward_and_the_dense_forward(runs):
    ranks = runs["ranks"][2]
    ours = ranks[0]["seg"]
    assert torch.equal(ranks[1]["seg"], ours)
    ref = runs["seg"]["logits"]
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(ours.numpy().argmax(-1), ref.argmax(-1))
    dense = runs["dense_logits"]
    assert float((ours - dense).abs().max()) <= 1e-5 * float(dense.abs().max())
    assert torch.equal(ours.argmax(-1), dense.argmax(-1))


@pytest.mark.parametrize("form", list(FORMS))
def test_mae_matches_s2tpu_on_uneven_token_shares(form, runs):
    ranks, mae = runs["ranks"][2], runs["mae"]
    ours = ranks[0][form]
    for rank in ranks[1:]:
        assert torch.equal(rank[form]["pred"], ours["pred"]) and torch.equal(rank[form]["loss"], ours["loss"])
        assert all(torch.equal(rank[form]["grads"][n], g) for n, g in ours["grads"].items())
    # s2tpu's model on the same mesh: the forward
    np.testing.assert_allclose(float(ours["loss"]), float(mae[form]["loss"]), rtol=1e-5)
    assert float((ours["pred"] - mae[form]["pred"]).abs().max()) <= 1e-4 * float(mae[form]["pred"].abs().max())
    # jax.grad of s2tpu's dense model: every parameter's gradient
    _assert_close_run(ours, mae["dense"])
    # a LayerNorm's gradient from this rank's tokens alone is not the whole
    whole = mae["dense"]["grads"]["blocks.0.norm1.weight"]
    assert _rel_l2(ours["share"], whole) > 0.05


def test_token_share_parameters_are_named_for_each_form():
    """The gradients the trainer sums over the model axis: the LayerNorms'
    and the post-scatter biases under tp + cp, every block parameter under
    cp alone; none without a model group."""
    gen = torch.Generator().manual_seed(0)
    tp = tm.Block(64, 4, 4.0, "xla", 1e-5, gen, tensor_parallel=True)
    names = {id(p): n for n, p in tp.named_parameters()}
    assert sorted(names[id(p)] for p in tp.token_shard_parameters()) == [
        "attn.proj.bias", "mlp.fc2.bias", "norm1.bias", "norm1.weight", "norm2.bias", "norm2.weight"]
    dense = tm.Block(64, 4, 4.0, "xla", 1e-5, gen)
    assert [id(p) for p in dense.token_shard_parameters()] == [id(p) for p in dense.parameters()]
    assert tm.PrithviMAE(tm.PrithviConfig(**MAE, **FORMS["cp"])).token_shard_parameters() == []


@pytest.mark.parametrize("world", list(WORLDS))
def test_mae_trainer_steps_with_context_parallelism(world, runs):
    ranks, one, jax_losses = runs["ranks"][world], runs["one_steps"], runs["jax_losses"]
    ours = ranks[0]["trainer"]
    for rank in ranks[1:]:
        assert rank["trainer"]["digest"] == ours["digest"] and rank["trainer"]["losses"] == ours["losses"]
    np.testing.assert_allclose(ours["losses"], one["losses"], rtol=1e-5)
    for n, g in one["grads"].items():
        assert _rel_l2(ours["grads"][n], g) <= GRAD_RTOL, n
    for n, p in one["params"].items():
        assert float((ours["params"][n] - p).abs().max()) <= 2.5 * LR * CP_STEPS, n
    np.testing.assert_allclose(ours["losses"][0], jax_losses[0], rtol=1e-5)
    np.testing.assert_allclose(ours["losses"][1:], jax_losses[1:], rtol=1e-3)


def test_pipeline_stages_stay_refused():
    """Pipeline stages train since GPipe was ported
    (tests/test_torch_pipeline_parallel.py). With context parallelism they
    stay refused (both use the 'model' axis), and one process has no model
    axis for the stages."""
    from s2tpu_torch.configs import mae as mae_cfg
    from s2tpu_torch.parallel.pipeline import Pipeline
    from s2tpu_torch.train.mae_trainer import MAETrainer

    c = mae_cfg.base_config("small")
    c.model.pipeline_stages = 2
    with pytest.raises(ValueError, match="pipeline_stages=2 needs a mesh whose model axis holds 2 ranks"):
        MAETrainer(c, datamodule=None, model_config=CP, device="cpu")
    for config in (CP, tm.PrithviConfig(**MAE, **FORMS["cp"])):
        with pytest.raises(ValueError, match="'model' axis"):
            tm.PrithviMAE(config, pipeline=Pipeline(_two_rank_axis(), 2))


def _two_rank_axis():
    """A model axis of two ranks, as the refusals see it (no collective runs)."""
    from s2tpu_torch.parallel.mesh import ModelAxis

    return ModelAxis(None, 0, 2)
