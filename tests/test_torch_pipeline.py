"""s2tpu_torch input pipeline vs the JAX package's Datamodule on the conftest fixture.

The same config and seed must give the same split, epoch order (shuffled and
weighted), crops, host flips, padded eval batches with their mask, and
normalized batches, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2tpu.configs import segmentation as jax_cfg_lib
from s2tpu.data.augment import normalize as jax_normalize
from s2tpu.data.pipeline import Datamodule as JaxDatamodule
from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.data.augment import normalize
from s2tpu_torch.data.pipeline import Datamodule, HostBatch, prefetch_to_device


def _configure(c, data_dir, weighted: bool):
    dm = c.datamodule
    dm.dataset_cfg.data_dir = str(data_dir)
    dm.batch_size = 2
    dm.data_split = (0.5, 0.5, 0.0)
    dm.random_crop_size = 64
    dm.shuffle_seed = 3
    dm.class_distribution = [0.1, 0.3, 0.4, 0.2] if weighted else None
    return dm


def _pair(fixture_dir, weighted: bool = False):
    jcfg = _configure(jax_cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass"),
                      fixture_dir, weighted)
    pcfg = _configure(cfg_lib.base_config("efficientnet-unet-b0", aoi="small", label_map="osm-multiclass"),
                      fixture_dir, weighted)
    return JaxDatamodule(jcfg, process_count=1, process_index=0), Datamodule(pcfg)


def _assert_same(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("weighted", [False, True])
def test_split_and_train_batches_match(fixture_dir, weighted):
    theirs, ours = _pair(fixture_dir, weighted)
    for a, b in zip((ours.train_idx, ours.val_idx, ours.test_idx), (theirs.train_idx, theirs.val_idx, theirs.test_idx)):
        np.testing.assert_array_equal(a, b)
    if weighted:
        np.testing.assert_array_equal(ours._sample_weights, theirs._sample_weights)
    for epoch in (0, 1):  # random crops and host flips differ per epoch, identically on both sides
        _assert_same(ours.train_batches(epoch), theirs.train_batches(epoch))


def test_overfit_batches_match(fixture_dir):
    theirs, ours = _pair(fixture_dir)
    for dm in (theirs, ours):
        dm.cfg.augment = False
    _assert_same(ours.train_batches(0, overfit_batches=1), theirs.train_batches(0, overfit_batches=1))


def test_eval_batches_are_padded_with_a_mask(fixture_dir):
    theirs, ours = _pair(fixture_dir)
    batches = list(ours.eval_batches("val"))
    _assert_same(batches, theirs.eval_batches("val"))
    n_val = len(ours.val_idx)
    bs = ours.cfg.batch_size * ours.cfg.val_batch_size_multiplier
    assert n_val % bs != 0  # the fixture exercises the padding
    last = batches[-1]
    assert last.images.shape[0] == bs and last.mask.sum() == n_val % bs and not last.labels[~last.mask].any()


def test_mean_std_and_normalized_batch_match(fixture_dir):
    theirs, ours = _pair(fixture_dir)
    jm, js = theirs.mean_std()
    m, s = ours.mean_std()
    np.testing.assert_allclose(m, jm, rtol=1e-6)
    np.testing.assert_allclose(s, js, rtol=1e-6)
    images = next(ours.train_batches(0)).images
    ref = np.asarray(jax_normalize(jnp.asarray(images), jnp.asarray(jm), jnp.asarray(js), dtype=jnp.float32))
    got = normalize(torch.from_numpy(images), torch.from_numpy(jm), torch.from_numpy(js), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ignore_zero_label", [True, False])
def test_class_probabilities_match(fixture_dir, ignore_zero_label):
    from s2tpu.data import statistics as jax_statistics
    from s2tpu_torch.data import statistics

    theirs, ours = _pair(fixture_dir)
    expected = jax_statistics.get_class_probabilities(theirs.source, 4, ignore_zero_label, max_samples=4, seed=1)
    got = statistics.get_class_probabilities(ours.source, 4, ignore_zero_label, max_samples=4, seed=1)
    np.testing.assert_array_equal(got, expected)


def test_prefetch_yields_the_batches_with_int32_labels(fixture_dir):
    _, ours = _pair(fixture_dir)
    host = list(ours.train_batches(0))
    fetched = list(prefetch_to_device(iter(host), torch.device("cpu")))
    assert len(fetched) == len(host)
    for a, b in zip(fetched, host):
        assert a.labels.dtype == torch.int32 and a.mask.dtype == torch.bool
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y)


def test_prefetch_reraises_producer_errors():
    def broken():
        yield HostBatch(np.zeros((1, 2, 2, 6), np.int16), np.zeros((1, 2, 2), np.int32), np.ones(1, bool))
        raise OSError("unreadable segment")

    it = prefetch_to_device(broken(), torch.device("cpu"))
    next(it)
    with pytest.raises(OSError, match="unreadable segment"):
        next(it)
