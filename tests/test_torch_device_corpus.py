"""The device corpus and windowed steps: s2tpu_torch's corpus, flips and corpus epochs vs the JAX package's.

Inputs are made by numpy from a seed. Where the two frameworks draw their
own random numbers (flips, drop-connect, masking noise) the comparisons
either fix the draws (p = 0 and p = 1, flip flags given, drop-connect masks
of ones) or hold the port against itself: a corpus epoch against a streamed
epoch that takes the same host draws, windows against single steps, a
preempted run against an uninterrupted one, each bit for bit (one process,
one device, the same arithmetic). Everything runs on the CPU in f32: B0 and
a tiny Prithvi at 64^2 and 32^2 crops.
"""

import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.data import augment as jax_augment
from s2tpu.data import device_corpus as jax_dc
from s2tpu_torch.checkpoint.convert import unet_state_dict_from_jax
from s2tpu_torch.checkpoint.io import CheckpointManager
from s2tpu_torch.configs import mae as mae_cfg
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.data import augment, device_corpus
from s2tpu_torch.data.dataset import Sample, SegmentSource
from s2tpu_torch.data.pipeline import Datamodule
from s2tpu_torch.models.prithvi_mae import PrithviConfig
from s2tpu_torch.train.mae_trainer import MAETrainer
from s2tpu_torch.train.trainer import SegmentationTrainer
from tests.test_torch_trainer_extras import _running_stats_close, _seg_pair


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch CPU threads in this module, as the suite's other trainer
    modules hold them (several workers share the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class ArraySource(SegmentSource):
    """``n`` seeded segments of (H, W, 6), or (T, H, W, 6), int16 images and
    (H, W) uint8 labels of four classes, in memory."""

    def __init__(self, n: int, hw: tuple[int, int] = (96, 96), frames: int | None = None, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        lead = (frames,) if frames else ()
        self.x = rng.integers(0, 3000, size=(n, *lead, *hw, 6)).astype(np.int16)
        self.y = rng.integers(0, 4, size=(n, *hw)).astype(np.uint8)

    def __len__(self) -> int:
        return len(self.x)

    def __getitem__(self, i: int) -> Sample:
        return Sample(self.x[i], self.y[i])


# ---------------------------------------------------------------- gather ----
@pytest.mark.parametrize("frames", [None, 3], ids=["single-frame", "multi-temporal"])
def test_gather_equals_the_jax_gather(frames):
    src = ArraySource(5, hw=(40, 48), frames=frames)
    idx, ys, xs = (np.array(v, np.int32) for v in ([0, 3, 4, 3], [0, 8, 16, 5], [5, 0, 24, 11]))
    ours = device_corpus.DeviceCorpus(src, "cpu")
    imgs, lbls = ours.gather(*(torch.from_numpy(a) for a in (idx, ys, xs)), 24)
    theirs = jax_dc.DeviceCorpus(src)
    jimgs, jlbls = theirs.gather(jnp.asarray(idx), jnp.asarray(ys), jnp.asarray(xs), crop=24)
    assert ours.hw == theirs.hw == (40, 48) and ours.labels.dtype == torch.uint8
    assert imgs.dtype == torch.int16 and lbls.dtype == torch.int32
    np.testing.assert_array_equal(imgs.numpy(), np.asarray(jimgs))
    np.testing.assert_array_equal(lbls.numpy(), np.asarray(jlbls))
    for k in range(len(idx)):  # crop_slice_images against the JAX one, sample by sample
        one = device_corpus.crop_slice_images(ours.images, *(torch.from_numpy(a[k:k + 1]) for a in (idx, ys, xs)), 24)
        np.testing.assert_array_equal(
            one[0].numpy(), np.asarray(jax_dc.crop_slice_images(theirs.images, int(idx[k]), int(ys[k]), int(xs[k]), 24))
        )
    assert device_corpus.DeviceCorpus(src, "cpu", with_labels=False).labels is None


def test_sample_crop_batch_equals_the_jax_sampler():
    order = np.random.default_rng(1).permutation(40)
    for random_crop in (True, False):
        ours, theirs = np.random.default_rng(2), np.random.default_rng(2)
        for step in range(3):
            got = device_corpus.sample_crop_batch(ours, order, step, 8, (96, 80), 64, random_crop)
            want = jax_dc.sample_crop_batch(theirs, order, step, 8, (96, 80), 64, random_crop)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == np.int32
            idx, ys, xs = got
            np.testing.assert_array_equal(idx, order[step * 8:(step + 1) * 8])
            assert ys.min() >= 0 and ys.max() <= 32 and xs.min() >= 0 and xs.max() <= 16
    _, cy, cx = device_corpus.sample_crop_batch(np.random.default_rng(0), order, 0, 4, (96, 80), 64, False)
    np.testing.assert_array_equal(cy, 16)
    np.testing.assert_array_equal(cx, 8)


# ----------------------------------------------------------------- flips ----
def _flip_inputs(frames: int | None):
    rng = np.random.default_rng(3)
    lead = (frames,) if frames else ()
    images = rng.integers(-100, 100, size=(6, *lead, 8, 10, 3)).astype(np.int16)
    labels = rng.integers(0, 4, size=(6, 8, 10)).astype(np.int32)
    return images, labels


@pytest.mark.parametrize("frames", [None, 2], ids=["single-frame", "multi-temporal"])
@pytest.mark.parametrize("p", [0.0, 1.0])
def test_random_flips_equal_the_jax_flips_where_the_draws_decide_nothing(p, frames):
    images, labels = _flip_inputs(frames)
    got = augment.random_flips(torch.from_numpy(images), torch.from_numpy(labels), torch.Generator().manual_seed(0),
                               p_horizontal=p, p_vertical=p)
    want = jax_augment.random_flips(jnp.asarray(images), jnp.asarray(labels), jax.random.key(0), p, p)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("frames", [None, 2], ids=["single-frame", "multi-temporal"])
def test_apply_flips_with_the_jax_flags_equals_the_jax_flips(frames):
    """The JAX flips' own flags (their draws re-made from the key, as
    ``random_flips`` makes them) given to the port: the same images and
    labels, every frame of a sample flipped with it."""
    images, labels = _flip_inputs(frames)
    key = jax.random.key(1)
    kh, kv = jax.random.split(key)
    flip_h = np.asarray(jax.random.uniform(kh, (6,) + (1,) * (images.ndim - 1)) < 0.5).reshape(6)
    flip_v = np.asarray(jax.random.uniform(kv, (6,) + (1,) * (images.ndim - 1)) < 0.5).reshape(6)
    assert flip_h.any() and not flip_h.all() and flip_v.any() and not flip_v.all()
    got = augment.apply_flips(torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(flip_h),
                              torch.from_numpy(flip_v))
    want = jax_augment.random_flips(jnp.asarray(images), jnp.asarray(labels), key, 0.5, 0.5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    normalized, _ = augment.augment_batch(torch.from_numpy(images), None, None, torch.zeros(3), torch.ones(3),
                                          dtype=torch.float32, train=False)
    assert torch.equal(normalized, torch.from_numpy(images).float())


# ------------------------------------------------------- segmentation -----
def _seg_config(batch: int = 2, **train):
    c = cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass")
    c.datamodule.batch_size = batch
    c.datamodule.random_crop_size = 32
    c.datamodule.data_split = (1.0, 0.0, 0.0)
    c.train.compute_dtype = "float32"
    c.train.num_devices = 1
    c.train.loss_type = cfg_lib.LossType("focal")
    c.train.weighted_loss = True
    c.train.class_distribution = [0.1, 0.3, 0.4, 0.2]
    c.train.watch_interval = 0
    for k, v in train.items():
        setattr(c.train, k, v)
    return c


def _seg_trainer(source, config, checkpoint_manager=None) -> SegmentationTrainer:
    dm = Datamodule(config.datamodule, source=source)
    dm.set_mean_std(np.full(6, 1500.0, np.float32), np.full(6, 800.0, np.float32))
    return SegmentationTrainer(config, dm, checkpoint_manager=checkpoint_manager, device="cpu")


def _state(trainer) -> dict[str, torch.Tensor]:
    """Parameters, buffers and Adam's state of a trainer, by name."""
    out = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for i, st in enumerate(trainer.optimizer.state.values()):
        out.update({f"adam.{i}.{k}": v.clone() for k, v in st.items()})
    return out


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def seg_corpus_trainer():
    """One B0 corpus trainer (flips on the device, host_flips off, drop-
    connect on) over 14 in-memory segments of 48^2: 7 batches of 2 at 32^2
    crops. It is built once (the model's init is its slow part) and
    ``_reset`` puts it back at its initial state for each test."""
    trainer = _seg_trainer(ArraySource(14, hw=(48, 48)), _seg_config(device_corpus=True))
    trainer.dm.cfg.host_flips = False
    return trainer, {k: v.clone() for k, v in trainer.model.state_dict().items()}, trainer.corpus


def _reset(fixture, steps_per_dispatch: int = 1, corpus: bool = True, checkpoint_manager=None):
    """The module's trainer at its initial weights and statistics, with a
    fresh Adam and no step taken; ``corpus=False`` trains from the host
    stream instead."""
    trainer, init, dc = fixture
    trainer.model.load_state_dict(init)
    trainer.optimizer.state.clear()
    trainer.step, trainer.preempt_flag, trainer._skip_batches, trainer._resumed_from_preempt = 0, False, 0, False
    trainer.corpus = dc if corpus else None
    trainer.ckpt = checkpoint_manager
    trainer.config.train.steps_per_dispatch = steps_per_dispatch
    trainer.config.train.ckpt_every_n_epochs = 10**6  # only the preemption checkpoint is written
    return trainer


def test_corpus_epoch_equals_the_streamed_epoch_with_device_flips(seg_corpus_trainer):
    """Flips on the device (p 0.5) and drop-connect on: a corpus epoch and a
    streamed epoch with host_flips=False draw the same crops and flags and
    train the same seven steps, bit for bit (loss, confusion matrix,
    parameters, BatchNorm statistics, Adam)."""
    trainer = _reset(seg_corpus_trainer)
    assert trainer.device_flips
    a = trainer.run_train_epoch(0)
    corpus = _state(trainer)
    trainer = _reset(seg_corpus_trainer, corpus=False)
    b = trainer.run_train_epoch(0)
    assert trainer.step == 7 and a["loss"] == b["loss"]
    assert np.array_equal(a["confusion_matrix"], b["confusion_matrix"])
    _equal(corpus, _state(trainer))


def test_windows_of_three_equal_single_steps_across_a_sigterm(seg_corpus_trainer, tmp_path, monkeypatch):
    """steps_per_dispatch = 3 over an epoch of 7 batches, stopped by a
    SIGTERM in its first window: the preemption checkpoint records 3
    batches, the resumed run trains a window of 3 and a single step, and
    the run ends where 7 single steps end, bit for bit."""
    trainer = _reset(seg_corpus_trainer)
    trainer.fit(epochs=1)
    single = _state(trainer)
    window, sizes = SegmentationTrainer.train_window, []

    def stopped_window(self, draws):
        out = window(self, draws)
        sizes.append(len(draws))
        if len(sizes) == 1:
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(SegmentationTrainer, "train_window", stopped_window)
    trainer = _reset(seg_corpus_trainer, 3, checkpoint_manager=CheckpointManager(tmp_path / "run"))
    assert trainer.fit(epochs=1) == [] and trainer.step == 3 and sizes == [3]
    assert CheckpointManager(tmp_path / "run").restore_preempt()["batches_done"] == 3
    trainer = _reset(seg_corpus_trainer, 3, checkpoint_manager=CheckpointManager(tmp_path / "run"))
    assert trainer.resume_from_checkpoint() == 0 and trainer.step == 3
    trainer.fit(epochs=1)
    assert sizes == [3, 3, 1] and trainer.step == 7
    _equal(_state(trainer), single)


def test_one_corpus_step_tracks_the_jax_indexed_step(fixture_dir, tmp_path, monkeypatch):
    """One corpus step of the port against ``train_step_indexed`` of the JAX
    trainer on the same draws, at the same init (JAX weights converted):
    flips at p = 0, drop-connect masks of ones on both sides. The loss
    agrees to 1e-5 relative and the running statistics to 1e-4 (f32, other
    sums: the bounds of the streamed step in tests/test_torch_train.py), the
    confusion matrix exactly."""
    jt, pt = _seg_pair(fixture_dir, tmp_path, monkeypatch, batch=2, device_corpus=True)
    for c in (jt.config, pt.config):
        c.datamodule.augment = True
        c.datamodule.random_horizontal_flip_p = c.datamodule.random_vertical_flip_p = 0.0
    jt._build_steps()
    pt.device_flips = True
    draws = jax_dc.sample_crop_batch(np.random.default_rng(7), np.arange(6), 0, 2, jt.corpus.hw, 64)
    state, jm = jt.train_step_indexed(jt.state, jt.corpus.images, jt.corpus.labels, *draws, jt.base_rng)
    m = pt.train_window(np.stack(draws)[None])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(m["cm"].numpy(), np.asarray(jm["cm"]))
    _running_stats_close(pt.model, unet_state_dict_from_jax(jax.device_get(state.params),
                                                            jax.device_get(state.batch_stats)))


def test_bn_recalibration_gathers_the_jax_draws_from_the_corpus(seg_corpus_trainer):
    """``tests/test_device_corpus.py:196``'s oracle for the port: corpus-mode
    recalibration never reads the host stream, and its statistics are
    finite and new. Its batches are the JAX package's: the same permutation
    and crops from (shuffle_seed, 0x5EED) (``_recal_stats_corpus``)."""
    trainer = _reset(seg_corpus_trainer)
    dmc = trainer.config.datamodule
    rng = np.random.default_rng((dmc.shuffle_seed, 0x5EED))
    order = rng.permutation(trainer.dm.train_idx)
    want = [jax_dc.sample_crop_batch(rng, order, b, 2, trainer.corpus.hw, 32) for b in range(2)]
    got, gather = [], trainer.corpus.gather

    def recorded(idx, ys, xs, crop):
        got.append(tuple(t.numpy() for t in (idx, ys, xs)))
        return gather(idx, ys, xs, crop)

    def boom(*args, **kwargs):
        raise AssertionError("corpus-mode recalibration read the host stream")

    stream, trainer.dm.train_batches, trainer.corpus.gather = trainer.dm.train_batches, boom, recorded
    before = trainer.model.encoder.stem[1].running_var.clone()
    try:
        trainer.recalibrate_bn(n_batches=2)
    finally:
        trainer.dm.train_batches = stream
        del trainer.corpus.gather
    after = trainer.model.encoder.stem[1].running_var
    assert len(got) == 2 and all(np.array_equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
    assert bool(torch.isfinite(after).all()) and not torch.equal(before, after)


# ------------------------------------------------------------------- MAE ----
TINY = dict(img_size=32, patch_size=8, num_frames=1, tubelet_size=1, in_chans=6, embed_dim=64, depth=2,
            num_heads=4, decoder_embed_dim=48, decoder_depth=1, decoder_num_heads=4, attention_impl="fused")


def _mae_trainer(source, augment_on: bool, **train) -> MAETrainer:
    c = mae_cfg.base_config("small")
    c.datamodule.batch_size, c.datamodule.random_crop_size = 2, 32
    c.datamodule.data_split, c.datamodule.augment = (1.0, 0.0, 0.0), augment_on
    c.model.mask_ratio = 0.5
    c.train.from_scratch, c.train.compute_dtype = True, "float32"
    for k, v in train.items():
        setattr(c.train, k, v)
    dm = Datamodule(cfg_lib.DatamoduleConfig(dataset_cfg=cfg_lib.DatasetConfig(aoi="small", label_map="osm-multiclass"),
                                             batch_size=2, data_split=(1.0, 0.0, 0.0), augment=augment_on,
                                             random_crop_size=32), source=source)
    return MAETrainer(c, dm, model_config=PrithviConfig(**TINY), device="cpu")


def test_mae_corpus_epoch_equals_the_streamed_epoch_without_augmentation():
    """Augmentation off (center crops, no flips): the MAE corpus epoch and
    the streamed epoch take the same crops and the same masking noise, and
    train the same two steps, bit for bit."""
    src = ArraySource(4, hw=(48, 48))
    corpus, streamed = _mae_trainer(src, False, device_corpus=True), _mae_trainer(src, False)
    assert corpus.corpus.labels is None
    a, b = corpus.run_train_epoch(0), streamed.run_train_epoch(0)
    assert np.isfinite(a["loss"]) and a["loss"] == b["loss"] and corpus.step == streamed.step == 2
    _equal(_state(corpus), _state(streamed))


def test_mae_corpus_windows_with_device_flips_equal_single_steps(monkeypatch):
    """Flips on the device (the MAE corpus's only augmentation): windows of
    2 over 3 batches train what 3 single steps do, bit for bit, and the
    flips draw before the masking noise from the micro-batch's generator."""
    src = ArraySource(6, hw=(48, 48))
    single = _mae_trainer(src, True, device_corpus=True)
    windowed = _mae_trainer(src, True, device_corpus=True, steps_per_dispatch=2)
    flips = []
    random_flips = augment.random_flips
    monkeypatch.setattr("s2tpu_torch.train.mae_trainer.random_flips",
                        lambda x, y, g, **kw: flips.append(x.shape) or random_flips(x, y, g, **kw))
    a, b = single.run_train_epoch(0), windowed.run_train_epoch(0)
    assert len(flips) == 6 and np.isfinite(a["loss"]) and a["loss"] == b["loss"] and windowed.step == 3
    _equal(_state(single), _state(windowed))
    assert json.dumps(b)  # host floats only
