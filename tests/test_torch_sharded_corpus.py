"""The sharded device corpus of s2tpu_torch (``--device-corpus-sharded``): each rank holds its block of the segments, against the JAX package.

Without a process group: the block bookkeeping (``shard_pools``), the draws
(``sharded_epoch_orders``: unweighted, weighted, overfit, and the errors on
pools too small; ``sample_sharded_crop_batch``) equal ``s2tpu``'s from the
same generator states, bit for bit; each data rank's block (a ``DataAxis``
of the rank's index and size, from the GeoTIFF tree and from a packed
memmap) equals the JAX corpus's shard on the same device of
``make_mesh(d)``, the wrap-around padding included; crops gathered by local
ids equal the source's crops.

Two gloo ranks (``tests/test_torch_multi_card.py::_sharded_worker``, spawned
once for the module while this process runs the JAX trainers on
``make_mesh(2)`` from the same init): B0 (focal + weighted, f32, lr 1e-4)
and the tiny MAE (f32, lr 1e-3, the JAX masking noise passed in) train one
epoch from the sharded corpus with no flips and, for B0, drop-connect
keeping every sample (the JAX package's masks come from its own keys).
Tolerances, those of ``tests/test_torch_data_parallel.py``'s epoch and of
the JAX-held steps: the epoch's train loss to 1e-3 relative, B0's val loss
and metrics to 1e-3 and its val confusion matrix within 8 pixels; the same
epoch in windows of 2 steps equals one step at a time, bit for bit (eager
on the CPU); BatchNorm recalibration from the blocks against the JAX
package's from its shards, to the forward's f32 tolerance that
``tests/test_torch_trainer_extras.py`` holds recalibration to, 1e-4 of
max(|ref|, 1) (measured 1.03e-5, through B0's 16 blocks).
"""

import jax
import numpy as np
import pytest
import torch

from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.data import device_corpus as jdc
from s2tpu.data.dataset import TiffSource as JaxTiffSource
from s2tpu.data.pipeline import Datamodule as JaxDatamodule
from s2tpu.parallel import mesh as jax_mesh
from s2tpu.train.trainer import SegmentationTrainer as JaxTrainer
from s2tpu_torch.checkpoint.convert import prithvi_state_dict_from_jax, unet_state_dict_from_jax
from s2tpu_torch.data import device_corpus as dc
from s2tpu_torch.data.dataset import TiffSource, pack_dataset
from s2tpu_torch.parallel.mesh import DataAxis
from tests.test_torch_multi_card import (  # noqa: F401 - dp_data_dir is a fixture
    DENSE, DP_BATCH, DP_DIST, GEOMETRY, LR, MAE_DP_BATCH, _sharded_worker, dp_data_dir, dp_ranks, join_ranks,
    mae_dp_config,
)

EPOCH_RTOL, CM_PIXELS, RECAL_TOL = 1e-3, 8, 1e-4
SPAWN_TIMEOUT_S = 600
SCENARIOS = ("blocks", "seg_epoch", "seg_windows", "seg_recal", "mae_epoch")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# no process group: the blocks and the draws
# ---------------------------------------------------------------------------
def _corpora(data_dir, d: int):
    """The port's block for each data rank of ``d`` and the JAX corpus
    sharded over ``make_mesh(d)``."""
    ours = [dc.DeviceCorpus(TiffSource("small", "osm-multiclass", data_dir), "cpu", data=DataAxis(None, r, d))
            for r in range(d)]
    theirs = jdc.DeviceCorpus(JaxTiffSource("small", "osm-multiclass", data_dir=data_dir),
                              mesh=jax_mesh.make_mesh(d), shard=True)
    return ours, theirs


def _shard(array: jax.Array, k: int) -> np.ndarray:
    """The rows of ``array`` that data rank ``k``'s device holds."""
    (shard,) = [s for s in array.addressable_shards if s.index[0].start // s.data.shape[0] == k]
    return np.asarray(shard.data)


@pytest.mark.parametrize("d", [2, 3])
def test_each_block_equals_the_jax_shard_padding_included(d, dp_data_dir, tmp_path):
    """16 segments over 2 ranks split evenly; over 3 the last block ends in
    two wrap-around copies of segments 0 and 1. A packed memmap's blocks
    (read from the rank's slice) equal the tree's."""
    ours, theirs = _corpora(dp_data_dir, d)
    packed = pack_dataset(TiffSource("small", "osm-multiclass", dp_data_dir), tmp_path / "p")
    for k, block in enumerate(ours):
        assert block.sharded and block.n_local == theirs.n_local == -(-16 // d)
        np.testing.assert_array_equal(block.images.numpy(), _shard(theirs.images, k))
        np.testing.assert_array_equal(block.labels.numpy().astype(np.int32), _shard(theirs.labels, k))
        from_pack = dc.DeviceCorpus(packed, "cpu", data=DataAxis(None, k, d))
        assert torch.equal(from_pack.images, block.images) and torch.equal(from_pack.labels, block.labels)
    assert not dc.DeviceCorpus(packed, "cpu", data=DataAxis(None, 0, 1)).sharded  # one rank: the plain corpus


@pytest.mark.parametrize("d", [2, 3])
def test_shard_pools_and_draws_equal_the_jax_package(d, dp_data_dir):
    ours, theirs = _corpora(dp_data_dir, d)
    train_idx = np.random.default_rng(4).permutation(16)[:13]
    pools = ours[0].shard_pools(train_idx)
    assert all(np.array_equal(a, b) for a, b in zip(pools, theirs.shard_pools(train_idx)))
    weights = [np.random.default_rng(5 + k).random(len(p)) + 0.1 for k, p in enumerate(pools)]
    for overfit, w in ((0, None), (0, weights), (2, None), (3, weights)):
        a = dc.sharded_epoch_orders(np.random.default_rng(9), pools, 2, overfit, weights=w)
        b = jdc.sharded_epoch_orders(np.random.default_rng(9), pools, 2, overfit, weights=w)
        assert a[1] == b[1] > 0 and all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
        for random_crop in (True, False):
            ra, rb = np.random.default_rng(11), np.random.default_rng(11)
            for step in range(a[1]):
                da = dc.sample_sharded_crop_batch(ra, a[0], step, 2, (96, 96), 64, random_crop)
                db = jdc.sample_sharded_crop_batch(rb, b[0], step, 2, (96, 96), 64, random_crop)
                assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(da, db))
    for fn in (dc.sharded_epoch_orders, jdc.sharded_epoch_orders):
        with pytest.raises(ValueError, match="smallest shard train pool"):
            fn(np.random.default_rng(0), pools, 16, 0)
        with pytest.raises(ValueError, match="overfit shard pool is empty"):
            fn(np.random.default_rng(0), [*pools[:-1], pools[-1][:0]], 2, 1)


def test_crops_gathered_by_local_ids_equal_the_sources(dp_data_dir):
    ours, _ = _corpora(dp_data_dir, 3)
    source = TiffSource("small", "osm-multiclass", dp_data_dir)
    rng = np.random.default_rng(2)
    for k, block in enumerate(ours):
        local = rng.integers(0, block.n_local, 5).astype(np.int32)
        ys, xs = (rng.integers(0, 96 - 64 + 1, 5).astype(np.int32) for _ in range(2))
        images, labels = block.gather(*(torch.from_numpy(a) for a in (local, ys, xs)), 64)
        for j, (i, y, x) in enumerate(zip(local, ys, xs)):
            s = source[int((k * block.n_local + i) % 16)]
            np.testing.assert_array_equal(images[j].numpy(), s.x[y:y + 64, x:x + 64])
            np.testing.assert_array_equal(labels[j].numpy(), s.y[y:y + 64, x:x + 64].astype(np.int32))


@pytest.mark.parametrize("module", ["train_segmentation", "train_mae"])
def test_cli_flag_implies_the_corpus_as_the_jax_cli_does(module):
    import importlib

    ours, theirs = (importlib.import_module(f"{pkg}.cli.{module}") for pkg in ("s2tpu_torch", "s2tpu"))
    argv = (["small", "osm-multiclass", "efficientnet-unet-b0"] if module == "train_segmentation" else ["small"])
    argv += ["--device-corpus-sharded", "--num-devices", "2"]
    t, jt = (m.config_from_args(m.build_parser().parse_args(argv)).train for m in (ours, theirs))
    assert (t.device_corpus, t.device_corpus_sharded) == (jt.device_corpus, jt.device_corpus_sharded) == (True, True)


# ---------------------------------------------------------------------------
# two gloo ranks against the JAX trainers on make_mesh(2)
# ---------------------------------------------------------------------------
def _jax_seg_trainer(data_dir) -> JaxTrainer:
    c = jax_cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = DP_BATCH
    c.datamodule.random_crop_size = 64
    c.datamodule.augment = False
    c.train.compute_dtype = "float32"
    c.train.loss_type = c.train.loss_type.__class__("focal")
    c.train.weighted_loss = True
    c.train.class_distribution = list(DP_DIST)
    c.train.lr = 1e-4
    c.train.watch_interval = 0
    c.train.num_devices = 2
    c.train.device_corpus = c.train.device_corpus_sharded = True
    return JaxTrainer(c, JaxDatamodule(c.datamodule, process_count=1, process_index=0), mesh=jax_mesh.make_mesh(2))


def _jax_mae_trainer(data_dir):
    from s2tpu.configs import mae as jax_mae_cfg
    from s2tpu.configs.segmentation import DatamoduleConfig, DatasetConfig
    from s2tpu.models.prithvi_mae import PrithviConfig
    from s2tpu.train.mae_trainer import MAETrainer

    ours = mae_dp_config(data_dir)
    c = jax_mae_cfg.base_config(aoi="small")
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = MAE_DP_BATCH
    c.datamodule.random_crop_size = 64
    c.datamodule.data_split = ours.datamodule.data_split
    c.datamodule.augment = False
    c.model.mask_ratio = ours.model.mask_ratio
    c.train.from_scratch = True
    c.train.lr = LR
    c.train.compute_dtype = "float32"
    c.train.watch_interval = 0
    c.train.device_corpus = c.train.device_corpus_sharded = True
    dm = JaxDatamodule(
        DatamoduleConfig(dataset_cfg=DatasetConfig(aoi="small", label_map="osm-multiclass", data_dir=str(data_dir)),
                         batch_size=MAE_DP_BATCH, data_split=c.datamodule.data_split, random_crop_size=64,
                         augment=False),
        source=JaxTiffSource("small", "osm-multiclass", data_dir=data_dir, require_labels=False),
        process_count=1, process_index=0,
    )
    return MAETrainer(c, dm, mesh=jax_mesh.make_mesh(2), model_config=PrithviConfig(**GEOMETRY))


def _mae_noise(jt, step: int) -> np.ndarray:
    """The JAX MAE step's masking noise: the step folded into the base key,
    split, drawn."""
    _, mask_key = jax.random.split(jax.random.fold_in(jt.base_rng, step))
    return np.array(jax.random.uniform(mask_key, (MAE_DP_BATCH, DENSE.num_patches)))


def _val_counts(val: dict) -> np.ndarray:
    return np.rint(np.asarray(val["confusion_matrix"]) * np.asarray(val["support"])[:, None])


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dp_data_dir):
    data_dir = str(dp_data_dir)
    tmp = tmp_path_factory.mktemp("sharded_ranks")
    jseg, jmae = _jax_seg_trainer(dp_data_dir), _jax_mae_trainer(dp_data_dir)
    init = jseg.state
    torch.save(unet_state_dict_from_jax(jax.device_get(init.params), jax.device_get(init.batch_stats)),
               tmp / "jax_seg_init.pt")
    torch.save(prithvi_state_dict_from_jax(jax.device_get(jmae.state.params), DENSE), tmp / "jax_mae_init.pt")
    torch.save([torch.from_numpy(_mae_noise(jmae, s)) for s in range(4)], tmp / "jax_mae_noise.pt")
    ctx = torch.multiprocessing.spawn(_sharded_worker, args=(str(tmp), data_dir, 2, SCENARIOS), nprocs=2,
                                      join=False)
    try:
        refs = {}
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.random, "bernoulli", lambda key, p, shape: jax.numpy.ones(shape, bool))
            jseg.recalibrate_bn(2)
            recal = unet_state_dict_from_jax(jax.device_get(jseg.state.params), jax.device_get(jseg.state.batch_stats))
            refs["seg_recal"] = {n: t for n, t in recal.items() if "running" in n}
            jseg.state = init
            train = jseg.run_train_epoch(0)
            val = jseg.run_eval_epoch("val")
        refs["seg_epoch"] = {"train_loss": train["loss"], "val": val, "val_cm": _val_counts(val)}
        refs["mae_epoch"] = {"train_loss": jmae.run_train_epoch(0)["loss"], "steps": int(jmae.state.step)}
        refs["n_local"] = jseg.corpus.n_local
    finally:
        join_ranks(ctx, 2, SPAWN_TIMEOUT_S, tmp)
    return {"refs": refs, "ranks": dp_ranks(tmp, 2)}


def test_each_rank_uploads_only_its_block(runs, dp_data_dir):
    ours, _ = _corpora(dp_data_dir, 2)
    for k, rank in enumerate(runs["ranks"]):
        b = rank["blocks"]
        assert b["sharded"] and b["n_local"] == runs["refs"]["n_local"] == 8 and b["images"].shape[0] == 8
        assert torch.equal(b["images"], ours[k].images) and torch.equal(b["labels"], ours[k].labels)
        assert rank["mae_epoch"]["images"][0] == 8 and rank["mae_epoch"]["labels"] is None  # the MAE: images only


def test_segmentation_epoch_from_the_blocks_tracks_the_jax_sharded_trainer(runs):
    ref = runs["refs"]["seg_epoch"]
    first = runs["ranks"][0]["seg_epoch"]
    for rank in runs["ranks"]:
        ours = rank["seg_epoch"]
        assert ours["digest"] == first["digest"]  # the ranks' training states, bit for bit
        np.testing.assert_allclose(ours["train_loss"], ref["train_loss"], rtol=EPOCH_RTOL)
        np.testing.assert_allclose(ours["val"]["loss"], ref["val"]["loss"], rtol=EPOCH_RTOL)
        for k in ("iou", "accuracy", "f1"):
            assert abs(ours["val"][k] - ref["val"][k]) <= EPOCH_RTOL, k
        assert ours["val_cm"].sum() == ref["val_cm"].sum() > 0
        assert np.abs(ours["val_cm"] - ref["val_cm"]).sum() <= CM_PIXELS


def test_windows_from_the_blocks_equal_single_steps(runs):
    for rank in runs["ranks"]:
        assert rank["seg_windows"]["digest"] == rank["seg_epoch"]["digest"]
        assert rank["seg_windows"]["train_loss"] == rank["seg_epoch"]["train_loss"]


def test_bn_recalibration_from_the_blocks_equals_the_jax_shards(runs):
    ref = runs["refs"]["seg_recal"]
    for rank in runs["ranks"]:
        assert set(rank["seg_recal"]) == set(ref)
        for n, s in ref.items():
            assert float(((rank["seg_recal"][n] - s).abs() / s.abs().clamp_min(1.0)).max()) <= RECAL_TOL, n


def test_mae_epoch_from_the_blocks_tracks_the_jax_sharded_trainer(runs):
    ref = runs["refs"]["mae_epoch"]
    for rank in runs["ranks"]:
        assert rank["mae_epoch"]["steps"] == ref["steps"] > 0
        np.testing.assert_allclose(rank["mae_epoch"]["train_loss"], ref["train_loss"], rtol=EPOCH_RTOL)
