"""The native crop gather: s2tpu_torch.native against the JAX package's and numpy.

``gather.cc`` is host C++ built with g++ at first use; these tests skip
where it cannot be built (the fixture asks, never the import). Every
comparison is exact: the gather copies integers.
"""

import threading

import numpy as np
import pytest

from s2tpu import native as jax_native
from s2tpu_torch import native


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    if lib is None:
        pytest.skip("g++ cannot build the native gather here")
    return lib


def _numpy_gather(images, labels, indices, ys, xs, crop, flip_h=None, flip_v=None):
    out = np.empty((len(indices), crop, crop, images.shape[-1]), np.int16)
    lout = np.empty((len(indices), crop, crop), np.int32)
    for k, (i, y0, x0) in enumerate(zip(indices, ys, xs)):
        img, lbl = images[i, y0:y0 + crop, x0:x0 + crop], labels[i, y0:y0 + crop, x0:x0 + crop]
        if flip_h is not None and flip_h[k]:
            img, lbl = img[:, ::-1], lbl[:, ::-1]
        if flip_v is not None and flip_v[k]:
            img, lbl = img[::-1], lbl[::-1]
        out[k], lout[k] = img, lbl
    return out, lout


@pytest.mark.parametrize("num_threads", [0, 1, 3], ids=["all-threads", "one-thread", "three-threads"])
@pytest.mark.parametrize("flips", [False, True], ids=["no-flips", "flips"])
def test_gather_equals_the_jax_gather_and_numpy(lib, num_threads, flips):
    rng = np.random.default_rng(7)
    images = rng.integers(-2000, 4000, size=(10, 48, 52, 6)).astype(np.int16)
    labels = rng.integers(0, 5, size=(10, 48, 52)).astype(np.uint8)
    b, crop = 9, 24
    indices = rng.integers(0, 10, size=b)
    ys, xs = rng.integers(0, 48 - crop + 1, size=b), rng.integers(0, 52 - crop + 1, size=b)
    flip = dict(flip_h=rng.random(b) < 0.5, flip_v=rng.random(b) < 0.5) if flips else {}
    out, lout = native.gather_crops(images, labels, indices, ys, xs, crop, num_threads=num_threads, **flip)
    assert out.dtype == np.int16 and out.shape == (b, crop, crop, 6)
    assert lout.dtype == np.int32 and lout.shape == (b, crop, crop)
    theirs = jax_native.gather_crops(images, labels, indices, ys, xs, crop, num_threads=num_threads, **flip)
    ref = _numpy_gather(images, labels, indices, ys, xs, crop, **flip)
    for a, t, r in zip((out, lout), theirs, ref):
        np.testing.assert_array_equal(a, t)
        np.testing.assert_array_equal(a, r)


def test_bad_inputs_return_none_or_raise(lib):
    images = np.zeros((2, 8, 8, 2), np.float32)
    labels = np.zeros((2, 8, 8), np.uint8)
    one = (np.array([0]), np.array([0]), np.array([0]), 4)
    assert native.gather_crops(images, labels, *one) is None  # not int16: the numpy path
    assert native.gather_crops(np.zeros((2, 8, 8, 2), np.int16)[:, :, ::2], labels, *one) is None  # strided
    with pytest.raises(ValueError, match="outside"):
        native.gather_crops(np.zeros((2, 8, 8, 2), np.int16), labels, np.array([0]), np.array([5]), np.array([0]), 4)
    with pytest.raises(ValueError, match="outside"):
        native.gather_crops(np.zeros((2, 8, 8, 2), np.int16), labels, np.array([2]), np.array([0]), np.array([0]), 4)
    with pytest.raises(ValueError, match="do not match"):
        native.gather_crops(np.zeros((2, 8, 8, 2), np.int16), labels[:1], *one)


def test_an_edited_source_gets_a_new_library_name(tmp_path, monkeypatch):
    src = tmp_path / "gather.cc"
    src.write_bytes(native.SRC.read_bytes())
    monkeypatch.setattr(native, "SRC", src)
    before = native.library_path()
    src.write_text(src.read_text() + "\n// edited\n")
    after = native.library_path()
    assert before != after and before.parent == after.parent == native.BUILD_DIR
    assert after.name.startswith("libs2tpu_native_") and after.suffix == ".so"


def test_concurrent_builds_leave_one_whole_library(lib, tmp_path, monkeypatch):
    """Builders that start together each write a temporary file and rename
    it into place: the library loads and no temporary file is left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    path = native.library_path()
    results = []
    threads = [threading.Thread(target=lambda: results.append(native._build(path))) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and results == [True] * 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]
    import ctypes

    native._bind(ctypes.CDLL(str(path)))


def test_datamodule_takes_the_native_branch_for_a_packed_source(lib, fixture_dir, tmp_path, monkeypatch):
    from s2tpu_torch.configs.segmentation import DatamoduleConfig, DatasetConfig
    from s2tpu_torch.data.dataset import TiffSource, pack_dataset
    from s2tpu_torch.data.pipeline import Datamodule

    src = TiffSource("small", "osm-multiclass", data_dir=fixture_dir)
    packed = pack_dataset(src, tmp_path / "packed")
    calls = []
    gather = native.gather_crops
    monkeypatch.setattr(native, "gather_crops", lambda *a, **k: calls.append(k) or gather(*a, **k))
    cfg = DatamoduleConfig(dataset_cfg=DatasetConfig(aoi="small", label_map="osm-multiclass"), batch_size=2,
                           data_split=(1.0, 0.0, 0.0), random_crop_size=64)
    batches = list(Datamodule(cfg, source=packed).train_batches(epoch=0))
    assert len(calls) == len(batches) == 3 and all(k["flip_h"] is not None for k in calls)
    for a, b in zip(batches, Datamodule(cfg, source=src).train_batches(epoch=0)):  # the numpy path, same draws
        assert a.images.shape == (2, 64, 64, 6)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
