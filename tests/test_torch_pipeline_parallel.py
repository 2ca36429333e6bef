"""GPipe pipeline parallelism in s2tpu_torch: the port of ``s2tpu/parallel/pipeline.py`` against the JAX package.

Gloo ranks on the CPU, spawned once for the module (the rank worker
``_pp_worker`` lives in the JAX-free ``tests/test_torch_multi_card.py``):
four on 1 x 4 and 2 x 2 meshes and two on a 1 x 2 mesh, while this process
runs the references of ``tests/test_pipeline_parallel.py`` on the
reference's tiny MAE (img 32, patch 8, width 64, 4 blocks, a decoder 48 wide
of 2 blocks, 4 heads): ``s2tpu.parallel.pipeline`` on ``make_mesh(8,
model_parallel=S)``, its weights carried across by ``convert.py``, its
masking noise drawn as its ``random_masking`` draws it. The ranks of a
model axis hold every row.

Tolerances (f32), those of ``tests/test_pipeline_parallel.py``: forwards
rtol = atol = 1e-5, gradients rtol 2e-4 and atol 1e-5, the full MAE's
predictions rtol 1e-4 and atol 1e-5; masks and ids equal. The reference
holds its pipelined gradients to its sequential ones, the same arithmetic
in XLA; the port's gradients are held so to the port's sequential model,
and to ``s2tpu``'s with the absolute bound taken of each gradient's scale
(1e-5 of its largest entry): these gradients reach 245, and the port's
sequential encoder misses the unscaled bound by as much as its pipeline
does (cls_token 2.6e-4 off at 245: sums in another order). The ranks of a
model axis agree bit for bit.

The trainer: ``MAETrainer`` with ``pipeline_stages=2`` on a 2 x 2 mesh (PP:
the tiny ViT of the MAE data-axis tests with 4 + 2 blocks) for two steps
from ``s2tpu``'s init and with its masking noise, against the port's one
process (losses 1e-5, the first step's gradients 1e-4 in relative L2, the
parameters after Adam's first step rtol 2e-3 and atol 3e-5, the reference's
slow ``test_mae_train_step_pipelined_matches_sequential`` bounds, but 2 lr
for an entry whose gradient is rounding noise, below 1e-4 of its tensor's
largest: Adam's first step moves it by +-lr whatever its size, and the key
biases' gradients are such noise, softmax being blind to them) and
against ``s2tpu``'s ``MAETrainer`` with ``pipeline_stages=2`` on
``make_mesh(4, model_parallel=2)`` (step 1's loss 1e-5, step 2's 1e-3, as
``tests/test_torch_mae_data_parallel.py``). Then ``cli.train_mae --pp 2
--num-devices 2 --device cpu`` on two ranks against the one-process CLI run.
"""

import dataclasses

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
from s2tpu.models import prithvi_mae as jm
from s2tpu.parallel import mesh as jax_mesh
from s2tpu.parallel import pipeline as jp
from s2tpu.train.mae_trainer import MAETrainer as JaxMAETrainer
from s2tpu_torch.checkpoint.convert import prithvi_state_dict_from_jax
from s2tpu_torch.models import prithvi_mae as tm
from s2tpu_torch.parallel import mesh as mesh_lib
from s2tpu_torch.parallel import pipeline as pp
from tests.test_torch_multi_card import (  # noqa: F401 - dp_data_dir is a fixture
    GRAD_RTOL, LR, PP, PP_BASE, PP_BATCH, PP_EXTRAS, PP_STEPS, _pp_worker, _rel_l2, dp_data_dir, dp_ranks, join_ranks,
    mae_dp_config, mae_dp_global_batch, mae_dp_trainer, pp_cli_run, pp_trainer_steps,
)

SPAWN_TIMEOUT_S = 600  # a guard: the ranks take ~20 s alone, longer beside the suite's other workers
FWD, GRAD_RTOL_PP, GRAD_ATOL = 1e-5, 2e-4, 1e-5
NOISE_GRAD = 1e-4  # a gradient entry below this share of its tensor's largest is rounding noise
KEYS = {"masked": 7, "decode": 3, "mae": 11, "fallback": 5}  # the reference tests' masking keys
ENCODE = [(1, 4), (4, 4), (2, 2)]
DECODE = [(1, 2), (2, 2)]
WORLDS = {
    4: (*(("encode", m, s) for m, s in ENCODE if s == 4), ("grads", 2, 4), ("fallback", 2, 4), ("trainer", 2, 2),
        ("extras", 2, 2), ("corpus", 2, 2)),
    2: (*(("encode", m, s) for m, s in ENCODE if s == 2), ("masked", 2, 2), *(("decode", m, s) for m, s in DECODE),
        ("mae", 2, 2), ("cli", 2, 2)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _noise(key: int, batch: int = 8) -> np.ndarray:
    """``random_masking``'s (B, L) noise of ``s2tpu``'s model at ``key``."""
    return np.array(jax.random.uniform(jax.random.key(key), (batch, tm.PrithviConfig(**PP_BASE).num_patches)))


def _references() -> tuple[dict, dict]:
    """``s2tpu``'s tiny MAE: the ranks' inputs and every reference of
    ``tests/test_pipeline_parallel.py``'s tests, from its own functions."""
    model = jm.PrithviMAE(jm.PrithviConfig(**PP_BASE))
    imgs = jnp.asarray(np.random.default_rng(0).normal(size=(8, 1, 32, 32, 6)).astype(np.float32))
    variables = jax.jit(lambda: model.init(jax.random.key(0), imgs, mask_ratio=0.0))()
    cot = jnp.asarray(np.random.default_rng(1).normal(size=(8, 17, 64)).astype(np.float32))
    meshes = {s: jax_mesh.make_mesh(8, model_parallel=s) for s in (2, 4)}
    refs = {}

    def on(s, fn, *args):
        with jax.set_mesh(meshes[s]):
            return jax.jit(fn)(*(jax.device_put(a, jax_mesh.data_sharding(meshes[s])) if a is not variables else a
                                 for a in args))

    for m, s in ENCODE:
        out, _, ids = on(s, lambda v, x: jp.prithvi_pipelined_encode(model, v, x, mesh=meshes[s], n_microbatches=m,
                                                                     mask_ratio=0.0), variables, imgs)
        refs[("encode", m, s)] = {"out": np.asarray(out), "ids": np.asarray(ids)}

    def encoder_loss(v, x):
        out, _, _ = jp.prithvi_pipelined_encode(model, v, x, mesh=meshes[4], n_microbatches=2, mask_ratio=0.0)
        return (out * cot).sum()

    refs[("grads", 2, 4)] = {"grads": on(4, jax.grad(encoder_loss), variables, imgs)}
    key = jax.random.key(KEYS["masked"])
    out, mask, ids = on(2, lambda v, x: jp.prithvi_pipelined_encode(model, v, x, mesh=meshes[2], n_microbatches=2,
                                                                    mask_ratio=0.5, mask_rng=key), variables, imgs)
    refs[("masked", 2, 2)] = {"out": np.asarray(out), "mask": np.asarray(mask), "ids": np.asarray(ids)}
    latent, _, ids = jax.jit(lambda v, x: model.apply(v, x, 0.5, jax.random.key(KEYS["decode"]),
                                                      method=jm.PrithviMAE.forward_encoder))(variables, imgs)
    for m, s in DECODE:
        pred = on(s, lambda v, t, i: jp.prithvi_pipelined_decode(model, v, t, i, mesh=meshes[s], n_microbatches=m),
                  variables, latent, ids)
        refs[("decode", m, s)] = {"pred": np.asarray(pred)}
    for name, s in (("mae", 2), ("fallback", 4)):
        key = jax.random.key(KEYS[name])
        loss, pred, mask = on(s, lambda v, x: jp.prithvi_pipelined_mae_forward(
            model, v, x, mesh=meshes[s], n_microbatches=2, mask_ratio=0.75, mask_rng=key), variables, imgs)
        refs[(name, 2, s)] = {"loss": float(loss), "pred": np.asarray(pred), "mask": np.asarray(mask)}
    key = jax.random.key(KEYS["mae"])
    refs[("mae", 2, 2)]["grads"] = jax.jit(jax.grad(lambda v, x: model.apply(v, x, 0.75, key)[0]))(variables, imgs)
    config = tm.PrithviConfig(**PP_BASE)
    for ref in refs.values():
        if "grads" in ref:
            grads = prithvi_state_dict_from_jax(jax.device_get(ref["grads"])["params"], config)
            ref["grads"] = {n: g for n, g in grads.items() if n not in tm.PrithviMAE.POS_KEYS}
    state = prithvi_state_dict_from_jax(jax.device_get(variables)["params"], config)
    for key, ref in refs.items():  # the port's sequential model: its gradients, the same masking noise
        if "grads" in ref:
            ref["sequential"] = _sequential_grads(state, key[0], imgs, cot, _noise(KEYS["mae"]))
    given = {"state": state,
             "imgs": torch.from_numpy(np.array(imgs)), "cot": torch.from_numpy(np.array(cot)),
             "latent": torch.from_numpy(np.array(latent)), "ids": torch.from_numpy(np.array(ids)),
             "noise": {name: torch.from_numpy(_noise(k)) for name, k in KEYS.items()}}
    return given, refs


def _sequential_grads(state: dict, name: str, imgs, cot, noise) -> dict[str, torch.Tensor]:
    """Every parameter's gradient of the port's tiny MAE run whole on one
    process: the encoder against ``cot`` (``grads``) or the full MAE's loss
    (``mae``)."""
    model = tm.PrithviMAE(tm.PrithviConfig(**PP_BASE))
    model.load_state_dict(state, strict=True)
    x = torch.from_numpy(np.array(imgs))
    if name == "grads":
        out, _, _ = model.forward_encoder(x, 0.0)
        (out * torch.from_numpy(np.array(cot))).sum().backward()
    else:
        model(x, mask_ratio=0.75, noise=torch.from_numpy(noise))[0].backward()
    return {n: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def _jax_pp_trainer(data_dir) -> JaxMAETrainer:
    """``s2tpu``'s MAETrainer of ``mae_dp_config``'s run at PP_BATCH with
    ``pipeline_stages=2`` on ``make_mesh(4, model_parallel=2)``."""
    ours = mae_dp_config(data_dir, PP_BATCH)
    c = jax_mae_cfg.base_config(aoi="small")
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = PP_BATCH
    c.datamodule.random_crop_size = 64
    c.datamodule.data_split = ours.datamodule.data_split
    c.datamodule.augment = False
    c.model.mask_ratio = ours.model.mask_ratio
    c.model.pipeline_stages = c.model.pipeline_microbatches = 2
    c.train.from_scratch = True
    c.train.lr = LR
    c.train.compute_dtype = "float32"
    dm = JaxDatamodule(
        JaxDatamoduleConfig(
            dataset_cfg=JaxDatasetConfig(aoi="small", label_map="osm-multiclass", data_dir=str(data_dir)),
            batch_size=PP_BATCH, data_split=c.datamodule.data_split, random_crop_size=64, augment=False,
        ),
        source=JaxTiffSource("small", "osm-multiclass", data_dir=data_dir, require_labels=False),
        process_count=1, process_index=0,
    )
    geometry = {k: v for k, v in dataclasses.asdict(PP).items() if k in jm.PrithviConfig.__dataclass_fields__}
    return JaxMAETrainer(c, dm, mesh=jax_mesh.make_mesh(4, model_parallel=2),
                         model_config=jm.PrithviConfig(**{**geometry, "tp_axis": None, "cp_axis": None}))


def _jax_trainer_noise(jt: JaxMAETrainer, step: int) -> np.ndarray:
    _, mask_key = jax.random.split(jax.random.fold_in(jt.base_rng, step))
    return np.array(jax.random.uniform(mask_key, (PP_BATCH, PP.num_patches)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dp_data_dir):
    data_dir = str(dp_data_dir)
    tmp = {world: tmp_path_factory.mktemp(f"pp{world}") for world in WORLDS}
    given, refs = _references()
    jt = _jax_pp_trainer(dp_data_dir)
    given["trainer_state"] = prithvi_state_dict_from_jax(jax.device_get(jt.state.params), PP)
    given["trainer_noise"] = [torch.from_numpy(_jax_trainer_noise(jt, step)) for step in range(PP_STEPS)]
    images, _ = mae_dp_global_batch(dp_data_dir, PP_BATCH)
    given["trainer_images"] = images
    for world in WORLDS:
        torch.save(given, tmp[world] / "pp_inputs.pt")
    contexts = {world: torch.multiprocessing.spawn(_pp_worker, args=(str(tmp[world]), data_dir, world, scenarios),
                                                   nprocs=world, join=False) for world, scenarios in WORLDS.items()}
    try:
        one = mae_dp_trainer(data_dir, None, PP, device="cpu", batch=PP_BATCH)
        one.model.load_state_dict(given["trainer_state"], strict=True)
        one_steps = pp_trainer_steps(one, images, given["trainer_noise"])
        extras = mae_dp_trainer(data_dir, None, PP, device="cpu", batch=PP_BATCH, **PP_EXTRAS)
        extras.model.load_state_dict(given["trainer_state"], strict=True)
        one_extras = pp_trainer_steps(extras, images, given["trainer_noise"])
        jax_losses, state = [], jt.state
        with jax.set_mesh(jt.mesh):
            sharded = jax.device_put(jnp.asarray(images), jax_mesh.data_sharding(jt.mesh))
            for _ in range(PP_STEPS):
                state, m = jt.train_step(state, sharded, jt.base_rng)
                jax_losses.append(float(m["loss"]))
        one_cli = pp_cli_run(dp_data_dir, str(tmp_path_factory.mktemp("pp_one_cli")), [])
    finally:
        for world, ctx in contexts.items():
            join_ranks(ctx, world, SPAWN_TIMEOUT_S, tmp[world])
    return {"ranks": {world: dp_ranks(tmp[world], world) for world in WORLDS}, "refs": refs, "given": given,
            "one_steps": one_steps, "one_extras": one_extras, "jax_losses": jax_losses, "one_cli": one_cli}


def _ours(runs, key) -> dict:
    """Rank 0's record of scenario ``key`` after checking that every rank
    of its world holds the same, bit for bit."""
    ranks = [r for world, rs in runs["ranks"].items() for r in rs if key in r]
    first = ranks[0][key]
    for rank in ranks[1:]:
        for k, v in first.items():
            same = all(torch.equal(rank[key][k][n], g) for n, g in v.items()) if k == "grads" else torch.equal(
                rank[key][k], v)
            assert same, (key, k)
    return first


def _assert_grads(ours: dict, ref: dict) -> None:
    """Every gradient against the port's sequential model's at the
    reference's bounds, and against ``s2tpu``'s with the absolute bound of
    each gradient's scale."""
    assert set(ours) == set(ref["grads"]) == set(ref["sequential"])
    for n, g in ref["sequential"].items():
        np.testing.assert_allclose(ours[n].numpy(), g.numpy(), rtol=GRAD_RTOL_PP, atol=GRAD_ATOL, err_msg=n)
    for n, g in ref["grads"].items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(ours[n].numpy(), g.numpy(), rtol=GRAD_RTOL_PP, atol=GRAD_ATOL * scale, err_msg=n)


@pytest.mark.parametrize("m,s", ENCODE)
def test_pipelined_encoder_matches_s2tpu(m, s, runs):
    ours, ref = _ours(runs, ("encode", m, s)), runs["refs"][("encode", m, s)]
    np.testing.assert_allclose(ours["out"].numpy(), ref["out"], rtol=FWD, atol=FWD)
    np.testing.assert_array_equal(ours["ids"].numpy(), ref["ids"])


def test_pipelined_encoder_grads_match_s2tpu(runs):
    """Every parameter's gradient through 4 stages: each block's gradient
    counted once (the stages' sum), those upstream (patch embedding, cls
    token) from stage 0's input gradient copied to every rank, the
    decoder's zero."""
    ours = _ours(runs, ("grads", 2, 4))["grads"]
    _assert_grads(ours, runs["refs"][("grads", 2, 4)])
    assert float(ours["patch_embed.proj.weight"].abs().max()) > 0 and float(ours["decoder_pred.weight"].abs().max()) == 0


def test_pipelined_masked_encoder(runs):
    ours, ref = _ours(runs, ("masked", 2, 2)), runs["refs"][("masked", 2, 2)]
    np.testing.assert_array_equal(ours["mask"].numpy(), ref["mask"])
    np.testing.assert_array_equal(ours["ids"].numpy(), ref["ids"])
    np.testing.assert_allclose(ours["out"].numpy(), ref["out"], rtol=FWD, atol=FWD)


@pytest.mark.parametrize("m,s", DECODE)
def test_pipelined_decoder_matches_s2tpu(m, s, runs):
    ours, ref = _ours(runs, ("decode", m, s)), runs["refs"][("decode", m, s)]
    np.testing.assert_allclose(ours["pred"].numpy(), ref["pred"], rtol=FWD, atol=FWD)


def test_pipelined_mae_forward_and_grads_match_s2tpu(runs):
    """Both stacks pipelined (2 stages divide 4 and 2 blocks): loss, pred and
    mask against ``s2tpu``'s pipelined forward, every gradient against
    ``jax.grad`` of its sequential model (the non-slow analog of
    ``test_pipelined_mae_forward_full_matches_sequential``)."""
    ours, ref = _ours(runs, ("mae", 2, 2)), runs["refs"][("mae", 2, 2)]
    np.testing.assert_array_equal(ours["mask"].numpy(), ref["mask"])
    np.testing.assert_allclose(float(ours["loss"]), ref["loss"], rtol=FWD)
    np.testing.assert_allclose(ours["pred"].numpy(), ref["pred"], rtol=1e-4, atol=1e-5)
    _assert_grads(ours["grads"], ref)


def test_pipelined_mae_forward_indivisible_decoder_falls_back(runs):
    assert PP_BASE["decoder_depth"] % 4 != 0
    ours, ref = _ours(runs, ("fallback", 2, 4)), runs["refs"][("fallback", 2, 4)]
    np.testing.assert_allclose(float(ours["loss"]), ref["loss"], rtol=FWD)
    np.testing.assert_allclose(ours["pred"].numpy(), ref["pred"], rtol=1e-4, atol=1e-5)
    # the decoder ran whole on every rank: its gradients are not stage shares
    model = tm.PrithviMAE(tm.PrithviConfig(**PP_BASE), pipeline=pp.Pipeline(mesh_lib.ModelAxis(None, 0, 4), 2))
    assert pp.pipelined_stacks(model) == [model.blocks]


def test_stage_r_holds_its_blocks_of_the_models_own_stack():
    """The counterpart of ``test_stack_block_params_roundtrip``: stage r of S
    runs blocks [r·d/S, (r+1)·d/S) of the model's ``blocks``, the modules
    themselves, so the state dict keeps the checkpoint layout."""
    model = tm.PrithviMAE(tm.PrithviConfig(**PP_BASE))
    depth = PP_BASE["depth"]
    for s in (1, 2, 4):
        stages = [pp.stage_blocks(model.blocks, r, s) for r in range(s)]
        assert [b for stage in stages for b in stage] == list(model.blocks)
        for r, stage in enumerate(stages):
            assert list(stage) == list(model.blocks)[r * depth // s:(r + 1) * depth // s]
    stage2 = pp.stage_blocks(model.blocks, 2, 4)[0]
    assert stage2.attn.qkv.weight is model.blocks[2].attn.qkv.weight
    piped = tm.PrithviMAE(tm.PrithviConfig(**PP_BASE), pipeline=pp.Pipeline(mesh_lib.ModelAxis(None, 0, 2), 2))
    assert piped.state_dict().keys() == model.state_dict().keys()
    assert [id(p) for p in pp.pipeline_parameters(piped)] == [
        id(p) for stack in (piped.blocks, piped.decoder_blocks) for p in stack.parameters()]


@pytest.mark.parametrize("axes,stages,match", [
    (dict(tp_axis="model"), 2, "model"), (dict(cp_axis="model"), 2, "model"),
    (dict(tp_axis="model", cp_axis="model"), 2, "model"), ({}, 8, "divisible"),
])
def test_pipeline_refuses_tp_cp_and_an_indivisible_depth(axes, stages, match):
    """Pipeline stages share the 'model' axis with tensor and context
    parallelism, and the encoder's 4 blocks do not split into 8 stages: the
    model and the reference's entry points refuse, as
    ``test_pipeline_rejects_tp_combination`` / ``..._indivisible_depth``."""
    pipeline = pp.Pipeline(mesh_lib.ModelAxis(None, 0, stages), 2)
    config = tm.PrithviConfig(**PP_BASE, **axes)
    with pytest.raises(ValueError, match=match):
        tm.PrithviMAE(config, pipeline=pipeline)
    with pytest.raises(ValueError, match=match):
        pp.prithvi_pipelined_encode(tm.PrithviMAE(config), torch.zeros(2, 1, 32, 32, 6), pipeline)


def test_mae_trainer_steps_with_pipeline_stages(runs):
    ranks, one, jax_losses = runs["ranks"][4], runs["one_steps"], runs["jax_losses"]
    ours = ranks[0]["trainer"]
    assert ours["axes"] == (2, 2)
    for rank in ranks[1:]:
        assert rank["trainer"]["digest"] == ours["digest"] and rank["trainer"]["losses"] == ours["losses"]
    np.testing.assert_allclose(ours["losses"], one["losses"], rtol=1e-5)
    for n, g in one["grads"].items():
        assert _rel_l2(ours["grads"][n], g) <= GRAD_RTOL, n
    for n, p in one["first"].items():
        # Adam's first step moves an entry whose gradient is rounding noise (the key bias's: softmax ignores
        # it) anywhere within 2 lr; every other entry within the reference's bounds.
        g = one["grads"][n].abs()
        noise = g <= NOISE_GRAD * float(g.max())
        bound = torch.where(noise, torch.full_like(p, 2 * LR), 3e-5 + 2e-3 * p.abs())
        excess = (ours["first"][n] - p).abs() - bound
        assert float(excess.max()) <= 0, (n, float(excess.max()), int(noise.sum()))
    np.testing.assert_allclose(ours["losses"][0], jax_losses[0], rtol=1e-5)
    np.testing.assert_allclose(ours["losses"][1:], jax_losses[1:], rtol=1e-3)


def test_trainer_extras_and_the_sharded_corpus_with_pipeline_stages(runs):
    """Remat of each block inside the stages, two accumulation micro-batches
    (each 2 rows a rank in 2 pipeline micro-batches) and the EMA: two steps
    on the 2 x 2 mesh against the one process with the same extras (losses
    1e-5, the first step's gradients 1e-4 in relative L2, the ranks' whole
    states equal). The sharded corpus in windows of 2 steps with device
    flips: the pipelined epoch's train and val losses those of the same
    ranks without stages (1e-5)."""
    ranks, one = runs["ranks"][4], runs["one_extras"]
    ours = ranks[0]["extras"]
    assert all(r["extras"]["digest"] == ours["digest"] for r in ranks)
    np.testing.assert_allclose(ours["losses"], one["losses"], rtol=1e-5)
    for n, g in one["grads"].items():
        assert _rel_l2(ours["grads"][n], g) <= GRAD_RTOL, n
    corpus = ranks[0]["corpus"]
    assert all(r["corpus"]["pipeline"]["digest"] == corpus["pipeline"]["digest"] for r in ranks)
    for k in ("train_loss", "val_loss"):
        assert np.isfinite(corpus["pipeline"][k])
        np.testing.assert_allclose(corpus["pipeline"][k], corpus["dense"][k], rtol=1e-5)


def test_cli_trains_with_pp_on_two_ranks(runs):
    """``cli.train_mae --pp 2 --pp-microbatches 2 --num-devices 2 --device
    cpu`` under the ranks' group: the run's config carries the stages, and
    its epoch's loss is the one-process run's."""
    ours = runs["ranks"][2][0]["cli"]
    assert ours["model"]["pipeline_stages"] == 2 and ours["model"]["pipeline_microbatches"] == 2
    assert runs["one_cli"]["model"]["pipeline_stages"] == 1
    loss, ref = ours["history"][0]["train/loss"], runs["one_cli"]["history"][0]["train/loss"]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, ref, rtol=1e-4)
