"""fc-prithvi on the data axis of s2tpu_torch's segmentation trainer: N ranks, one process each, against one process and against the JAX package.

Ranks are gloo processes on the CPU, spawned once per world size for the
module (2 and 3 ranks at once) while this process builds the references;
the workers and helpers live in the JAX-free
``tests/test_torch_multi_card.py`` (``_fc_dp_worker``), beside the NCCL card
test. fc-prithvi at test widths (a 2-block ViT of embed 64 and 4 heads,
patch 16, a head of 16), 64^2 crops, f32, weighted CE, dropout 0.1, a global
batch of 6 (3 rows a rank at 2 ranks, 2 at 3).

Tolerances:
- A frozen step, the unfreeze, then an unfrozen step on N ranks against the
  same on one process, the bounds of ``tests/test_torch_data_parallel.py``:
  loss to 1e-5 relative, the head's BatchNorm running statistics to 1e-5
  of max(|ref|, 1), the classifier's gradient to 1e-4 in relative L2, every
  other gradient to 5e-2 (a floor of 1e-6 of all gradients' norm) and all
  together to 2.5e-2. The dropout mask is the global batch's on every rank
  count, so only the order of f32 sums differs. The unfrozen step's
  statistics carry the first update: Adam moves the bias before the head's
  BatchNorm, whose gradient is rounding noise, by about lr (1e-4) on a sign
  the summation order picks, of which the running mean takes 0.1, so they
  are held to 1e-5 + 2e-5 (measured 1.5e-5; 1.5e-4 at lr 1e-3).
- Parameters, gradients and statistics across ranks: bit for bit.
- Against ``s2tpu``'s trainer on ``make_mesh(2)`` (its init through the
  weight converter, dropout 0, lr 1e-4, two frozen steps): step 1's loss to
  1e-5, step 2's to 1e-3, the bounds of ``tests/test_torch_train.py``'s
  JAX-held steps.
"""

import jax
import numpy as np
import pytest
import torch

from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.data.pipeline import Datamodule as JaxDatamodule
from s2tpu.models import prithvi_mae as jm
from s2tpu.models.prithvi_seg import PrithviSegmentationConfig as JaxSegConfig
from s2tpu.models.prithvi_seg import PrithviSegmentationNet as JaxSegNet
from s2tpu.parallel import mesh as jax_mesh
from s2tpu.train.trainer import SegmentationTrainer as JaxTrainer
from s2tpu_torch.checkpoint.convert import prithvi_seg_state_dict_from_jax
from tests.test_torch_multi_card import (  # noqa: F401 - dp_data_dir is a fixture
    DP_BATCH, DP_DIST, FC_DEPTH, FC_SECOND_STEP_STATS, FC_EMBED, FC_HEAD_WIDTH, FC_HEADS, _fc_dp_worker, assert_fc_dp_step_close,
    dp_data_dir, dp_ranks, fc_dp_global_batch, fc_dp_trainer, fc_frozen_then_unfrozen, join_ranks,
)

SPAWN_TIMEOUT_S = 600  # a guard: the ranks take ~20 s alone, longer beside the suite's other workers
WORLDS = {2: ("fc", "jax"), 3: ("fc",)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_trainer(data_dir) -> JaxTrainer:
    """The ranks' run in the JAX package: the same widths, dropout 0, lr
    1e-4, on a 2-device mesh."""
    c = jax_cfg_lib.base_config("fc-prithvi-backbone", aoi="small", label_map="osm-multiclass")
    c.datamodule.dataset_cfg.data_dir = str(data_dir)
    c.datamodule.batch_size = DP_BATCH
    c.datamodule.random_crop_size = 64
    c.train.compute_dtype = "float32"
    c.train.weighted_loss = True
    c.train.class_distribution = list(DP_DIST)
    c.train.lr = 1e-4
    c.train.watch_interval = 0
    c.train.num_devices = 2

    def build(config):
        crop, t = config.datamodule.random_crop_size, config.datamodule.dataset_cfg.n_time_frames
        backbone = jm.PrithviConfig(img_size=crop, patch_size=16, num_frames=t, in_chans=6, embed_dim=FC_EMBED,
                                    depth=FC_DEPTH, num_heads=FC_HEADS, decoder_embed_dim=48, decoder_depth=1,
                                    decoder_num_heads=4)
        return JaxSegNet(JaxSegConfig(num_frames=t, num_classes=config.num_classes, fcn_out_channels=FC_HEAD_WIDTH,
                                      fcn_num_convs=1, fcn_dropout=0.0, frozen_backbone=True, embed_dim=FC_EMBED,
                                      patch_height=crop // 16, patch_width=crop // 16, backbone=backbone))

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_cfg_lib.Config, "build_model", build)
        return JaxTrainer(c, JaxDatamodule(c.datamodule, process_count=1, process_index=0),
                          mesh=jax_mesh.make_mesh(2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dp_data_dir):
    data_dir = str(dp_data_dir)
    tmp = {world: tmp_path_factory.mktemp(f"fc_ranks{world}") for world in WORLDS}
    jtrainer = _jax_trainer(dp_data_dir)
    state = jax.device_get(jtrainer.state)
    port = fc_dp_trainer(data_dir, None, device="cpu", dropout=0.0)
    model = prithvi_seg_state_dict_from_jax(state.params, state.batch_stats, port.model.config.backbone)
    mean, std = (torch.as_tensor(np.asarray(v, np.float32)) for v in jtrainer.dm.mean_std())
    torch.save({"model": model, "mean": mean, "std": std}, tmp[2] / "jax_init.pt")
    contexts = {world: torch.multiprocessing.spawn(_fc_dp_worker, args=(str(tmp[world]), data_dir, world, names),
                                                   nprocs=world, join=False) for world, names in WORLDS.items()}
    try:
        images, labels = fc_dp_global_batch(data_dir)
        refs = {"fc": fc_frozen_then_unfrozen(fc_dp_trainer(data_dir, None, device="cpu"), images, labels)}
        sharding = jax_mesh.data_sharding(jtrainer.mesh)
        jstate, jlosses = jtrainer.state, []
        for _ in range(2):
            jstate, out = jtrainer.train_step(jstate, jax.device_put(images, sharding), jax.device_put(labels, sharding),
                                              jtrainer.base_rng)
            jlosses.append(float(out["loss"]))
        refs["jax"] = jlosses
    finally:
        for world, ctx in contexts.items():
            join_ranks(ctx, world, SPAWN_TIMEOUT_S, tmp[world])
    return {"refs": refs, "ranks": {world: dp_ranks(tmp[world], world) for world in WORLDS}}


@pytest.mark.parametrize("step", ["frozen", "unfrozen"])
@pytest.mark.parametrize("world", list(WORLDS))
def test_fc_prithvi_step_on_a_data_axis_equals_the_one_process_step(world, step, runs):
    ranks = [r["fc"] for r in runs["ranks"][world]]
    assert_fc_dp_step_close(ranks, step, runs["refs"]["fc"][step], 1e-5 if step == "frozen" else FC_SECOND_STEP_STATS)
    if step == "frozen":  # no gradient for the frozen backbone, on any rank
        assert not any(n.startswith("backbone.") for n in ranks[0]["frozen"]["grads"])
    else:
        assert any(n.startswith("backbone.") for n in ranks[0]["unfrozen"]["grads"])


@pytest.mark.parametrize("world", list(WORLDS))
def test_fc_prithvi_parameters_are_bit_equal_across_ranks_and_the_unfreeze_rebuilds_the_buckets(world, runs):
    first, *others = [r["fc"] for r in runs["ranks"][world]]
    for other in others:
        for step in ("frozen", "unfrozen"):
            assert other[step]["digest"] == first[step]["digest"] and other[step]["loss"] == first[step]["loss"]
    # one set of flat buffers for the head's gradients, one for every parameter's after the unfreeze
    assert all(r["fc"]["buckets"] == 2 for r in runs["ranks"][world])
    assert first["frozen"]["digest"]["params"] != first["unfrozen"]["digest"]["params"]


def test_fc_prithvi_on_two_ranks_tracks_the_jax_trainer_on_a_two_device_mesh(runs):
    jlosses = runs["refs"]["jax"]
    for rank in runs["ranks"][2]:
        np.testing.assert_allclose(rank["jax"][0], jlosses[0], rtol=1e-5)
        np.testing.assert_allclose(rank["jax"][1], jlosses[1], rtol=1e-3)
    assert abs(jlosses[1] - jlosses[0]) > 1e-3 * jlosses[0]  # the update moved the head


def test_dropout_keeps_the_global_masks_rows():
    """A rank's dropout mask is its rows of the one-process mask drawn from
    the same generator state."""
    from s2tpu_torch.models.prithvi_seg import Dropout
    from s2tpu_torch.parallel.mesh import DataAxis

    x = torch.ones(6, 3, 4, 5)
    one = Dropout(0.5).train()(x, torch.Generator().manual_seed(3))
    for index in range(3):
        d = Dropout(0.5).train()
        d.data_axis = DataAxis(None, index, 3)
        torch.testing.assert_close(d(x[2 * index:2 * index + 2], torch.Generator().manual_seed(3)),
                                   one[2 * index:2 * index + 2], rtol=0, atol=0)
