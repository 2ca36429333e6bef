"""s2tpu_torch's Grain input pipeline against the JAX package's: the same batches from the same source.

On the suite's synthetic AOI, the port's ``grain_train_batches`` over the
port's TiffSource gives the JAX package's batches over its own, image for
image and label for label, as the port's ``HostBatch``: drop-last batches,
int16 images and int32 labels, every row real; the same epoch repeats and
another epoch reshuffles. The reference is ``tests/test_grain_pipeline.py``.
"""

import numpy as np
import pytest

from s2tpu.configs.segmentation import DatamoduleConfig as JaxDatamoduleConfig
from s2tpu.configs.segmentation import DatasetConfig as JaxDatasetConfig
from s2tpu.data.dataset import TiffSource as JaxTiffSource
from s2tpu.data.grain_pipeline import grain_train_batches as jax_grain_train_batches
from s2tpu_torch.configs.segmentation import DatamoduleConfig, DatasetConfig
from s2tpu_torch.data.dataset import TiffSource
from s2tpu_torch.data.grain_pipeline import grain_available, grain_train_batches
from s2tpu_torch.data.pipeline import HostBatch

pytestmark = pytest.mark.skipif(not grain_available(), reason="grain not installed")


def _batches(fixture_dir, epoch: int, augment: bool = True, crop: int = 64):
    kw = dict(batch_size=2, data_split=(1.0, 0.0, 0.0), random_crop_size=crop, augment=augment)
    src = TiffSource("small", "osm-multiclass", data_dir=fixture_dir)
    ours = list(grain_train_batches(src, np.arange(6), DatamoduleConfig(
        dataset_cfg=DatasetConfig(aoi="small", label_map="osm-multiclass"), **kw), epoch=epoch))
    jsrc = JaxTiffSource("small", "osm-multiclass", data_dir=fixture_dir)
    theirs = list(jax_grain_train_batches(jsrc, np.arange(6), JaxDatamoduleConfig(
        dataset_cfg=JaxDatasetConfig(aoi="small", label_map="osm-multiclass"), **kw), epoch=epoch))
    return ours, theirs


@pytest.mark.parametrize("epoch,augment,crop", [(0, True, 64), (1, True, 64), (0, False, 48)])
def test_grain_batches_equal_the_jax_packages(fixture_dir, epoch, augment, crop):
    ours, theirs = _batches(fixture_dir, epoch, augment, crop)
    assert len(ours) == len(theirs) == 3  # drop-last at bs 2 over 6 samples
    for a, b in zip(ours, theirs):
        assert isinstance(a, HostBatch)
        assert a.images.shape == (2, crop, crop, 6) and a.images.dtype == np.int16
        assert a.labels.shape == (2, crop, crop) and a.labels.dtype == np.int32 and a.mask.all()
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_grain_batches_repeat_an_epoch_and_reshuffle_the_next(fixture_dir):
    a, _ = _batches(fixture_dir, 0)
    b, _ = _batches(fixture_dir, 0)
    c, _ = _batches(fixture_dir, 1)
    assert all(np.array_equal(x.images, y.images) for x, y in zip(a, b))
    assert any(not np.array_equal(x.images, y.images) for x, y in zip(a, c))
