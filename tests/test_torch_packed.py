"""Packed memmap and sharded record corpora: s2tpu_torch's against the JAX package's.

Both packages read and write the same files, byte for byte, so a corpus
packed by either opens in the other; ``open_source`` picks the same backend;
the Datamodule's batches from a pack equal the JAX package's on the same seed
(with and without host flips), and the device corpus uploaded from a pack
equals the one from the GeoTIFF tree. Every comparison is exact: the data
path has no arithmetic. The CLI trains the same steps from ``--source
packed`` and ``--source records`` as from ``--source tiff``, bit for bit
(B0, 64^2 crops, f32, on the CPU).
"""

import json
import logging
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from s2tpu.configs.segmentation import DatamoduleConfig as JaxDatamoduleConfig
from s2tpu.configs.segmentation import DatasetConfig as JaxDatasetConfig
from s2tpu.data import dataset as jax_dataset
from s2tpu.data import records as jax_records
from s2tpu.data.pipeline import Datamodule as JaxDatamodule
from s2tpu_torch.configs.segmentation import DatamoduleConfig, DatasetConfig
from s2tpu_torch.data import dataset, records
from s2tpu_torch.data.device_corpus import DeviceCorpus
from s2tpu_torch.data.pipeline import Datamodule

PACK_FILES = ("images.npy", "labels.npy", "meta.json")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch CPU threads in this module, as the suite's other trainer
    modules hold them (several workers share the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def data_dir(fixture_dir, tmp_path):
    """A private copy of the session's 6-segment fixture: packs land in its
    default location, which the shared fixture must not hold."""
    return shutil.copytree(fixture_dir, tmp_path / "data")


@pytest.fixture(scope="module")
def tiff(fixture_dir):
    return dataset.TiffSource("small", "osm-multiclass", data_dir=fixture_dir)


def _same_samples(a, b) -> None:
    assert len(a) == len(b)
    for i in range(len(a)):
        np.testing.assert_array_equal(a[i].x, b[i].x)
        np.testing.assert_array_equal(a[i].y, b[i].y)


def test_pack_dataset_writes_the_jax_package_files(tiff, fixture_dir, tmp_path):
    ours = dataset.pack_dataset(tiff, tmp_path / "ours")
    jax_dataset.pack_dataset(jax_dataset.TiffSource("small", "osm-multiclass", data_dir=fixture_dir), tmp_path / "theirs")
    for name in PACK_FILES:
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes(), name
    _same_samples(ours, tiff)
    imgs, lbls = ours.gather(np.array([0, 2]))
    assert imgs.shape == (2, 96, 96, 6) and lbls.shape == (2, 96, 96)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_pack_written_by_either_package_opens_in_the_other(tiff, tmp_path, writer):
    pack, packed_source = ((dataset.pack_dataset, jax_dataset.PackedSource) if writer == "port"
                           else (jax_dataset.pack_dataset, dataset.PackedSource))
    pack(tiff, tmp_path / "p")
    reader = packed_source(tmp_path / "p")
    _same_samples(reader, tiff)
    assert reader.meta == {"n": 6, "height": 96, "width": 96, "channels": 6}
    for a, b in zip(reader.gather(np.array([5, 1])), (np.stack([tiff[5].x, tiff[1].x]), np.stack([tiff[5].y, tiff[1].y]))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compress", [False, True])
def test_sharded_records_write_the_jax_package_bytes(tiff, tmp_path, compress):
    ours = records.write_sharded_records(tiff, tmp_path / "ours", records_per_shard=4, compress=compress)
    jax_records.write_sharded_records(tiff, tmp_path / "theirs", records_per_shard=4, compress=compress)
    names = sorted(p.name for p in (tmp_path / "theirs").iterdir())
    assert sorted(p.name for p in (tmp_path / "ours").iterdir()) == names
    assert ("shard-00001.idx.npy" in names) == compress and len(ours.meta["shards"]) == 2
    for name in names:
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes(), name
    _same_samples(ours, tiff)
    reread = records.RecordSource(tmp_path / "theirs", verify=True)  # the JAX package's corpus, verified
    _same_samples(reread, tiff)
    reread.close()
    jax_reader = jax_records.RecordSource(tmp_path / "ours", verify=True)
    _same_samples(jax_reader, tiff)
    jax_reader.close()
    ours.close()


def test_a_corrupted_record_raises_under_verify(tiff, tmp_path):
    records.write_sharded_records(tiff, tmp_path / "rec", records_per_shard=4, compress=False)
    shard = tmp_path / "rec" / "shard-00000.s2rec"
    data = bytearray(shard.read_bytes())
    data[100] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(IOError, match="crc mismatch"):
        records.RecordSource(tmp_path / "rec", verify=True)[0]
    assert records.RecordSource(tmp_path / "rec")[0].x.shape == tiff[0].x.shape  # verify=False reads through


def test_open_source_behaves_as_the_jax_package(data_dir, caplog):
    """No pack: the GeoTIFF tree; a memmap pack: PackedSource under auto and
    packed, an error under records; an s2rec corpus: RecordSource under auto
    and records, an error under packed; T > 1: always the GeoTIFF tree."""
    packed_dir = data_dir / "small" / "packed" / "osm-multiclass"

    def kinds() -> dict:
        out = {}
        for kind in ("auto", "tiff", "packed", "records"):
            row = []
            for open_source in (dataset.open_source, jax_dataset.open_source):
                try:
                    row.append(type(open_source("small", "osm-multiclass", data_dir=data_dir, kind=kind)).__name__)
                except FileNotFoundError:
                    row.append("FileNotFoundError")
            assert row[0] == row[1], (kind, row)
            out[kind] = row[0]
        multi = [type(f("small", "osm-multiclass", data_dir=data_dir, n_time_frames=2)).__name__
                 for f in (dataset.open_source, jax_dataset.open_source)]
        assert multi == ["TiffSource"] * 2
        return out

    fnf = "FileNotFoundError"
    assert kinds() == {"auto": "TiffSource", "tiff": "TiffSource", "packed": fnf, "records": fnf}
    tiff = dataset.TiffSource("small", "osm-multiclass", data_dir=data_dir)
    dataset.pack_dataset(tiff, packed_dir)
    assert kinds() == {"auto": "PackedSource", "tiff": "TiffSource", "packed": "PackedSource", "records": fnf}
    shutil.rmtree(packed_dir)
    records.write_sharded_records(tiff, packed_dir, records_per_shard=4)
    assert kinds() == {"auto": "RecordSource", "tiff": "TiffSource", "packed": fnf, "records": "RecordSource"}

    # auto says which pack it took, and warns when the GeoTIFF tree is newer than it
    meta = packed_dir / "meta.json"
    caplog.set_level(logging.INFO, logger="s2tpu_torch.data.dataset")
    dataset.open_source("small", "osm-multiclass", data_dir=data_dir)
    assert "using packed corpus" in caplog.text and "newer" not in caplog.text
    newest = max(p.stat().st_mtime for p in tiff.sentinel_files.values())
    os.utime(meta, (newest - 60, newest - 60))
    caplog.clear()
    dataset.open_source("small", "osm-multiclass", data_dir=data_dir)
    assert "may be stale" in caplog.text


def _configs(fixture_dir, host_flips: bool):
    kw = dict(batch_size=2, data_split=(0.5, 0.5, 0.0), random_crop_size=64, host_flips=host_flips,
              val_batch_size_multiplier=1)
    return (DatamoduleConfig(dataset_cfg=DatasetConfig(aoi="small", label_map="osm-multiclass",
                                                       data_dir=str(fixture_dir)), **kw),
            JaxDatamoduleConfig(dataset_cfg=JaxDatasetConfig(aoi="small", label_map="osm-multiclass",
                                                             data_dir=str(fixture_dir)), **kw))


@pytest.mark.parametrize("host_flips", [True, False], ids=["host-flips", "no-flips"])
def test_datamodule_batches_from_a_pack_equal_the_jax_package(tiff, fixture_dir, tmp_path, host_flips):
    dataset.pack_dataset(tiff, tmp_path / "p")
    cfg, jcfg = _configs(fixture_dir, host_flips)
    ours = Datamodule(cfg, source=dataset.PackedSource(tmp_path / "p"))
    theirs = JaxDatamodule(jcfg, source=jax_dataset.PackedSource(tmp_path / "p"), process_count=1, process_index=0)
    from_tiff = Datamodule(cfg, source=tiff)
    for epoch in (0, 1):
        got = list(ours.train_batches(epoch))
        assert len(got) == 1 and got[0].images.dtype == np.int16 and got[0].labels.dtype == np.int32
        for a, b, c in zip(got, theirs.train_batches(epoch), from_tiff.train_batches(epoch)):
            for field in ("images", "labels", "mask"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
                np.testing.assert_array_equal(getattr(a, field), getattr(c, field))
    for a, b in zip(ours.eval_batches("val"), theirs.eval_batches("val")):
        for field in ("images", "labels", "mask"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_device_corpus_from_a_pack_equals_the_one_from_the_tiff_tree(tiff, tmp_path):
    packed = dataset.pack_dataset(tiff, tmp_path / "p")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a read-only memmap handed to torch would warn
        ours = DeviceCorpus(dataset.PackedSource(tmp_path / "p"), "cpu")
    ref = DeviceCorpus(tiff, "cpu")
    assert ours.hw == ref.hw == (96, 96)
    assert torch.equal(ours.images, ref.images) and torch.equal(ours.labels, ref.labels)
    ours.images.add_(1)  # a copy: the pack on disk is untouched
    np.testing.assert_array_equal(dataset.PackedSource(tmp_path / "p").images, packed.images)
    unlabeled = DeviceCorpus(dataset.PackedSource(tmp_path / "p"), "cpu", with_labels=False)
    assert unlabeled.labels is None and torch.equal(unlabeled.images, ref.images)


@pytest.mark.parametrize("fmt", ["memmap", "sharded"])
def test_pack_cli_writes_what_open_source_finds(data_dir, fmt, capsys):
    from s2tpu.cli.pack import main as jax_pack
    from s2tpu_torch.cli.pack import main as pack

    extra = ["--format", "sharded", "--compress", "--records-per-shard", "4"] if fmt == "sharded" else []
    out = pack(["small", "osm-multiclass", "--data-dir", str(data_dir), *extra])
    assert out == data_dir / "small" / "packed" / "osm-multiclass"
    assert f"Packed 6 segments -> {out}" in capsys.readouterr().out
    source = dataset.open_source("small", "osm-multiclass", data_dir=data_dir)
    assert type(source).__name__ == ("PackedSource" if fmt == "memmap" else "RecordSource")
    _same_samples(source, dataset.TiffSource("small", "osm-multiclass", data_dir=data_dir))
    jax_pack(["small", "osm-multiclass", "--data-dir", str(data_dir), "--out", str(data_dir / "jax"), *extra])
    for p in sorted((data_dir / "jax").iterdir()):
        assert (out / p.name).read_bytes() == p.read_bytes(), p.name


@pytest.mark.parametrize("corpus", [False, True], ids=["streamed", "device-corpus"])
def test_cli_trains_the_same_steps_from_every_source(data_dir, tmp_path, monkeypatch, caplog, corpus):
    """``--source packed`` and ``--source records`` against ``--source
    tiff``: one epoch of B0 with host flips, the same logged losses and the
    same checkpoint, bit for bit; with ``--device-corpus`` (device flips),
    the corpus uploaded from the pack against the one from the tree."""
    from s2tpu_torch.checkpoint import io
    from s2tpu_torch.cli.pack import main as pack
    from s2tpu_torch.cli.train_segmentation import main as train_main
    from s2tpu_torch.configs import paths

    monkeypatch.setattr(paths, "CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(paths, "LOG_DIR", tmp_path / "logs")
    argv = ["small", "osm-multiclass", "efficientnet-unet-b0", "--loss-type", "focal", "--weighted-loss", "--bs", "2",
            "--crop", "64", "--compute-dtype", "float32", "--data-dir", str(data_dir), "--epochs", "1",
            "--log-interval", "1", "--device", "cpu", *(["--device-corpus"] if corpus else [])]
    caplog.set_level(logging.INFO)
    runs = {}
    for source in ("tiff", "packed") if corpus else ("tiff", "packed", "records"):
        packed_dir = data_dir / "small" / "packed" / "osm-multiclass"
        shutil.rmtree(packed_dir, ignore_errors=True)
        if source != "tiff":
            pack(["small", "osm-multiclass", "--data-dir", str(data_dir),
                  *(["--format", "sharded", "--compress"] if source == "records" else [])])
        caplog.clear()
        history = train_main([*argv, "--source", source, "--name", source])
        assert f"Input source: {dict(tiff='TiffSource', packed='PackedSource', records='RecordSource')[source]}" \
            in caplog.text
        (run_dir,) = (tmp_path / "ckpts").glob(f"*/{source}_*")
        steps = [json.loads(line)["train/loss_step"]
                 for line in (tmp_path / "logs" / "runs" / f"{run_dir.name}.metrics.jsonl").read_text().splitlines()
                 if "train/loss_step" in line]
        runs[source] = (history, steps, io.CheckpointManager(run_dir).restore(0))
    ref_history, ref_steps, ref_ckpt = runs["tiff"]
    assert len(ref_steps) == (0 if corpus else 2)  # corpus windows log no step losses
    for source in runs.keys() - {"tiff"}:
        history, steps, ckpt = runs[source]
        assert steps == ref_steps, source
        assert [{k: v for k, v in r.items() if "images_per_sec" not in k} for r in history] == \
            [{k: v for k, v in r.items() if "images_per_sec" not in k} for r in ref_history]
        assert ckpt["model"].keys() == ref_ckpt["model"].keys()
        assert all(torch.equal(ckpt["model"][k], ref_ckpt["model"][k]) for k in ref_ckpt["model"]), source
