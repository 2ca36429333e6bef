"""s2tpu_torch's acquisition engine, providers and download CLIs against the JAX package's, offline.

Both packages' engines run on the same fake fetchers (seeded frames, a
fifth of them cut-off mosaics that must be dropped; sparse and dense label
rasters), as ``tests/test_acquisition_cli.py`` drives the JAX one: the
GeoTIFFs they write read back equal, array and georeferencing, and so do
their metadata and resume files. The providers run on stand-in client
modules for sentinelhub and osmnx (neither is installed, and nothing here
touches the network); the CLIs on fake providers.
"""

import dataclasses
import json
import sys
import types
import warnings

import numpy as np
import pytest

from s2tpu.configs import data_config as jdc
from s2tpu.geo import acquisition as jacq
from s2tpu.geo import providers as jprov
from s2tpu.geo.tiff import read_geotiff as jax_read_geotiff
from s2tpu_torch.configs import data_config as tdc
from s2tpu_torch.geo import acquisition as acq
from s2tpu_torch.geo import providers as prov
from s2tpu_torch.geo.grid import calculate_segments
from s2tpu_torch.geo.tiff import read_geotiff

SEGMENTS = calculate_segments(tdc.AOIs["small"], tdc.SEGMENT_LENGTH_KM)  # 6 segments


def fake_sentinel(segment, interval):
    """A seeded (64, 64, 6) int16 frame of this segment and interval; every
    segment's second interval a cut-off mosaic (all zero)."""
    seed = int(abs(segment.west * 1e6)) % 10_000 + 7 * int(abs(segment.south * 1e6)) % 10_000
    month = int(interval[0][5:7])
    frame = np.random.default_rng(seed + month).integers(1, 4000, size=(64, 64, 6)).astype(np.int16)
    if month == 4:
        frame[:] = 0
    return frame


def sparse_labels(segment):
    r = np.zeros((64, 64), np.uint8)
    r[:2, :2] = 1  # mostly unlabeled
    return r


def dense_labels(segment):
    seed = int(abs(segment.west * 1e6)) % 10_000
    return np.random.default_rng(seed).integers(1, 4, size=(64, 64)).astype(np.uint8)


def _read_tree(root, sub) -> dict:
    out = {}
    for path in sorted((root / "small" / sub).glob("*.tif")):
        data, geo = read_geotiff(path)
        theirs, their_geo = jax_read_geotiff(path)
        np.testing.assert_array_equal(data, theirs)  # the two codecs agree on every file
        assert dataclasses.astuple(geo) == dataclasses.astuple(their_geo)
        out[path.name] = (data, geo)
    return out


def _assert_same_trees(ours, theirs):
    assert ours.keys() == theirs.keys() and ours
    for name, (data, geo) in ours.items():
        np.testing.assert_array_equal(data, theirs[name][0])
        assert data.dtype == theirs[name][0].dtype and geo == theirs[name][1], name


@pytest.mark.parametrize("frequency,count", [("QS", 4), ("MS", 12), ("2MS", 6)])
def test_split_time_interval_equals_the_jax_packages(frequency, count):
    ours = acq.split_time_interval(tdc.TIME_INTERVAL, frequency)
    assert ours == jacq.split_time_interval(jdc.TIME_INTERVAL, frequency) and len(ours) == count


@pytest.mark.parametrize("workers", [1, 3])
def test_download_sentinel_writes_the_jax_packages_dataset(tmp_path, workers):
    n = acq.download_sentinel("small", fake_sentinel, frequency="QS", workers=workers, data_dir=tmp_path / "ours",
                              segments=SEGMENTS)
    jn = jacq.download_sentinel("small", fake_sentinel, frequency="QS", workers=workers,
                                data_dir=tmp_path / "theirs", segments=[jdc.BBox(*s) for s in SEGMENTS])
    assert n == jn == 6 * 3  # each segment's cut-off second quarter dropped
    ours = _read_tree(tmp_path / "ours", "sentinel")
    _assert_same_trees(ours, _read_tree(tmp_path / "theirs", "sentinel"))
    assert sorted(ours) == sorted(f"{i}_{t}.tif" for i in range(6) for t in range(3))
    assert ours["0_0.tif"][0].shape == (6, 64, 64)
    meta = [(tmp_path / side / "small" / "metadata.json").read_bytes() for side in ("ours", "theirs")]
    assert meta[0] == meta[1]
    assert not (tmp_path / "ours" / "small" / "resume.json").exists()


def test_download_sentinel_resumes_as_the_jax_package_does(tmp_path):
    """A failed resumable run raises and leaves its resume state unfinalized; a run
    resumed from segments {0, 1, 4} done fetches only the others: in both
    packages alike, to the same files."""
    for side, engine, bbox in (("ours", acq, tdc.BBox), ("theirs", jacq, jdc.BBox)):
        segments = [bbox(*s) for s in SEGMENTS]

        def failing(segment, interval):
            raise OSError("connection reset")

        with pytest.raises(OSError, match="connection reset"):
            engine.download_sentinel("small", failing, data_dir=tmp_path / "failed" / side, segments=segments,
                                     resume=True)
        assert (tmp_path / "failed" / side / "small" / "metadata.tmp.json").exists()
        assert not (tmp_path / "failed" / side / "small" / "metadata.json").exists()
        base = tmp_path / side / "small"
        base.mkdir(parents=True)
        (base / "resume.json").write_text(json.dumps({"skip_indices": [0, 1, 4]}))
        calls = []
        engine.download_sentinel("small", lambda s, i, calls=calls: calls.append(tuple(s)) or fake_sentinel(s, i),
                                 data_dir=tmp_path / side, segments=segments, resume=True)
        assert set(calls) == {tuple(SEGMENTS[i]) for i in (2, 3, 5)}
    failed = [(tmp_path / "failed" / side / "small" / "metadata.tmp.json").read_bytes() for side in ("ours", "theirs")]
    assert failed[0] == failed[1]
    ours = _read_tree(tmp_path / "ours", "sentinel")
    _assert_same_trees(ours, _read_tree(tmp_path / "theirs", "sentinel"))
    assert sorted({name.split("_")[0] for name in ours}) == ["2", "3", "5"]


@pytest.mark.parametrize("label_map,fetch,expect", [
    ("osm-multiclass", sparse_labels, 0), ("osm-nature-binary", sparse_labels, 6), ("osm-multiclass", dense_labels, 6),
])
def test_download_labels_gate_and_files_equal_the_jax_packages(tmp_path, label_map, fetch, expect):
    """The multiclass quality gate skips mostly unlabeled rasters with a
    warning; binary maps save regardless; the rasters equal the JAX
    package's."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        n = acq.download_labels("small", label_map, fetch, data_dir=tmp_path / "ours", segments=SEGMENTS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jn = jacq.download_labels("small", label_map, fetch, data_dir=tmp_path / "theirs",
                                  segments=[jdc.BBox(*s) for s in SEGMENTS])
    assert n == jn == expect
    assert sum(issubclass(w.category, acq.LabelQualityWarning) for w in caught) == 6 - expect
    if expect:
        sub = f"label/{label_map}"
        _assert_same_trees(_read_tree(tmp_path / "ours", sub), _read_tree(tmp_path / "theirs", sub))


class _Request:
    """A stand-in of sentinelhub's request: records its arguments and
    returns the fake fetchers' data for its box."""

    last: dict = {}

    def __init__(self, **kwargs):
        _Request.last = kwargs

    @staticmethod
    def input_data(**kwargs):
        return kwargs

    @staticmethod
    def output_response(*args):
        return args

    def get_data(self, save_data=False):
        bbox = self.last["bbox"]
        west, south, east, north = bbox.coords
        segment = tdc.BBox(north=north, south=south, east=east, west=west)
        if "OCS" in self.last["evalscript"]:
            return [np.stack([dense_labels(segment)] * 3, axis=-1)]
        return [fake_sentinel(segment, self.last["input_data"][0]["time_interval"])]


def _fake_sentinelhub() -> types.ModuleType:
    sh = types.ModuleType("sentinelhub")
    sh.SHConfig = lambda **kwargs: kwargs
    sh.SentinelHubRequest = _Request
    sh.BBox = lambda coords, crs: types.SimpleNamespace(coords=coords, crs=crs)
    sh.CRS = types.SimpleNamespace(WGS84="wgs84")
    sh.DataCollection = types.SimpleNamespace(SENTINEL2_L2A="l2a", define_byoc=lambda cid: f"byoc:{cid}")
    sh.MosaickingOrder = types.SimpleNamespace(LEAST_CC="least_cc")
    sh.ResamplingType = types.SimpleNamespace(BICUBIC="bicubic")
    sh.MimeType = types.SimpleNamespace(TIFF="tiff")
    return sh


def _fake_osmnx() -> types.ModuleType:
    """osmnx whose every class query returns one square of its own in the
    segment's lower left (a class without features raises, as osmnx does)."""
    ox = types.ModuleType("osmnx")

    def features_from_bbox(bbox, tags):
        west, south, east, north = bbox
        k = len(repr(sorted(tags.items()))) % 5
        if k == 0:
            raise ValueError("no features")
        w, s = west + (east - west) * 0.1 * k, south + (north - south) * 0.1 * k
        e, n = w + (east - west) * 0.3, s + (north - south) * 0.3
        square = {"type": "Polygon", "coordinates": [[(w, s), (e, s), (e, n), (w, n), (w, s)]]}
        return types.SimpleNamespace(geometry=[types.SimpleNamespace(__geo_interface__=square), None])

    ox.features = types.SimpleNamespace(features_from_bbox=features_from_bbox)
    return ox


@pytest.mark.parametrize("kind", ["sentinel", "cnes", "osm"])
def test_providers_build_the_jax_packages_requests_and_rasters(kind, monkeypatch):
    """Each provider on stand-in clients: the same request settings and the
    same raster as the JAX package's provider, pixel for pixel."""
    monkeypatch.setitem(sys.modules, "sentinelhub", _fake_sentinelhub())
    monkeypatch.setitem(sys.modules, "osmnx", _fake_osmnx())
    segment = SEGMENTS[2]
    if kind == "sentinel":
        fetchers = [p.sentinel_fetcher(rate_limit_sleep=0.0, bands=tdc.BANDS_ALL12) for p in (prov, jprov)]
        args = (segment, ("2020-01-01", "2020-04-01"))
    elif kind == "cnes":
        fetchers = [p.cnes_label_fetcher(rate_limit_sleep=0.0) for p in (prov, jprov)]
        args = (segment,)
    else:
        fetchers = [p.osm_label_fetcher("osm-multiclass") for p in (prov, jprov)]
        args = (segment,)
    ours = fetchers[0](*args)
    request = dict(_Request.last)
    theirs = fetchers[1](*args)
    np.testing.assert_array_equal(ours, theirs)
    if kind != "osm":
        assert {k: v for k, v in request.items() if k != "bbox"} == {
            k: v for k, v in _Request.last.items() if k != "bbox"}
    else:
        assert ours.shape == tdc.SEGMENT_SIZE and len(np.unique(ours)) > 1


def test_providers_without_their_clients_say_what_to_install(monkeypatch):
    monkeypatch.setitem(sys.modules, "sentinelhub", None)
    monkeypatch.setitem(sys.modules, "osmnx", None)
    with pytest.raises(RuntimeError, match="pip install sentinelhub"):
        prov.sentinel_fetcher()
    with pytest.raises(RuntimeError, match="pip install sentinelhub"):
        prov.cnes_label_fetcher()
    with pytest.raises(RuntimeError, match="pip install osmnx"):
        prov.osm_label_fetcher("osm-multiclass")


@pytest.mark.parametrize("cli", ["sentinel", "labels"])
def test_download_clis_write_the_jax_clis_dataset(cli, tmp_path, monkeypatch, capsys):
    """The download CLIs on fake providers: the same files and printout as
    the JAX package's CLIs on the same fakes; a bad AOI or map exits."""
    from s2tpu.cli import download_labels as jdl, download_sentinel as jds
    from s2tpu_torch.cli import download_labels as dl, download_sentinel as ds

    for module in (prov, jprov):
        monkeypatch.setattr(module, "sentinel_fetcher", lambda bands=None, **kw: fake_sentinel)
        monkeypatch.setattr(module, "osm_label_fetcher", lambda label_map: dense_labels)
    monkeypatch.setattr(acq, "calculate_segments", lambda bbox, km: SEGMENTS[:3])
    monkeypatch.setattr(jacq, "calculate_segments", lambda bbox, km: [jdc.BBox(*s) for s in SEGMENTS[:3]])
    printed = []
    for side, main in (("ours", (ds if cli == "sentinel" else dl).main),
                       ("theirs", (jds if cli == "sentinel" else jdl).main)):
        argv = ["small"] + ([] if cli == "sentinel" else ["osm-multiclass"])
        main([*argv, "--data-dir", str(tmp_path / side), "--workers", "2"])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] == f"Collected {9 if cli == 'sentinel' else 3} " + (
        "sentinel images.\n" if cli == "sentinel" else "label rasters.\n")  # 3 segments (x 3 quarters kept)
    sub = "sentinel" if cli == "sentinel" else "label/osm-multiclass"
    _assert_same_trees(_read_tree(tmp_path / "ours", sub), _read_tree(tmp_path / "theirs", sub))
    with pytest.raises(SystemExit):
        (ds.main if cli == "sentinel" else dl.main)(["not-an-aoi"] if cli == "sentinel" else ["at", "bogus-map"])
