"""s2tpu_torch's segment grid, rasterization, resume protocol and acquisition constants against the JAX package's.

The same inputs through ``s2tpu.geo`` and ``s2tpu_torch.geo``: the grids of
every AOI segment for segment (the on-disk naming follows their order),
geodesic lengths and pixel sizes equal, rasters burned by both equal pixel
for pixel, and the resume files the two write equal byte for byte. The
references are ``tests/test_geo.py`` and ``tests/test_acquisition_cli.py``.
"""

import numpy as np
import pytest

from s2tpu.configs import data_config as jdc
from s2tpu.geo import grid as jgrid
from s2tpu.geo import rasterize as jras
from s2tpu.geo.resume import ResumeState as JaxResumeState
from s2tpu_torch.configs import data_config as tdc
from s2tpu_torch.geo import grid, rasterize
from s2tpu_torch.geo.resume import ResumeState


def test_acquisition_constants_equal_the_jax_packages():
    assert {k: tuple(v) for k, v in tdc.AOIs.items()} == {k: tuple(v) for k, v in jdc.AOIs.items()}
    assert tdc.AOI_NAMES == tuple(jdc.AOIs)
    assert str(tdc.AOIs["small"]) == str(jdc.AOIs["small"])
    for name in ("EPSG_WGS84", "TIME_INTERVAL", "SEGMENT_SIZE", "SEGMENT_LENGTH_KM", "MAX_CLOUD_COVER",
                 "MAX_UNLABELED", "ZERO_FRAME_THRESHOLD", "CNES_BYOC_COLLECTION_ID", "CNES_LABEL_EVALSCRIPT"):
        assert getattr(tdc, name) == getattr(jdc, name), name
    for bands in (None, tdc.BANDS_ALL12, ["B02", "B8A"]):
        assert tdc.sentinel2_evalscript(bands) == jdc.sentinel2_evalscript(bands)


@pytest.mark.parametrize("points", [
    (48.2082, 16.3738, 48.1351, 11.5820), (0.0, 0.0, 0.0, 1.0), (10, 20, 10, 20), (-33.9, 18.4, 51.5, -0.1),
])
def test_geodesic_km_equals_the_jax_packages(points):
    assert grid.geodesic_km(*points) == jgrid.geodesic_km(*points)


@pytest.mark.parametrize("aoi", list(jdc.AOIs))
def test_segment_grid_equals_the_jax_packages(aoi):
    ours = grid.calculate_segments(tdc.AOIs[aoi], tdc.SEGMENT_LENGTH_KM)
    theirs = jgrid.calculate_segments(jdc.AOIs[aoi], jdc.SEGMENT_LENGTH_KM)
    assert [tuple(s) for s in ours] == [tuple(s) for s in theirs]
    assert all(isinstance(s, tdc.BBox) for s in ours[:3])
    assert grid.pixel_size(ours[0], tdc.SEGMENT_SIZE) == jgrid.pixel_size(theirs[0], jdc.SEGMENT_SIZE)


def _square(w, s, e, n):
    return {"type": "Polygon", "coordinates": [[(w, s), (e, s), (e, n), (w, n), (w, s)]]}


GEOMETRIES = {
    "priority": ([_square(0.0, 0.0, 0.5, 1.0), _square(0.25, 0.25, 0.75, 0.75)], [1, 2]),
    "hole": ([{"type": "Polygon", "coordinates": [
        [(0.1, 0.1), (0.9, 0.1), (0.9, 0.9), (0.1, 0.9), (0.1, 0.1)],
        [(0.4, 0.4), (0.6, 0.4), (0.6, 0.6), (0.4, 0.6), (0.4, 0.4)]]}], [3]),
    "multi": ([{"type": "MultiPolygon", "coordinates": [[[(0.0, 0.0), (0.3, 0.0), (0.3, 0.3), (0.0, 0.0)]],
                                                         [[(0.6, 0.6), (0.9, 0.6), (0.9, 0.9), (0.6, 0.6)]]]},
               {"type": "GeometryCollection", "geometries": [_square(0.4, 0.0, 0.5, 1.0)]}], [1, 2]),
    "lines_points": ([{"type": "LineString", "coordinates": [(0.0, 0.5), (1.0, 0.5)]},
                      {"type": "MultiLineString", "coordinates": [[(0.1, 0.0), (0.1, 1.0)], [(0.0, 0.9), (0.5, 0.8)]]},
                      {"type": "Point", "coordinates": (0.25, 0.25)},
                      {"type": "MultiPoint", "coordinates": [(0.75, 0.75), (2.0, 2.0)]}], [1, 2, 3, 1]),
}


@pytest.mark.parametrize("case", list(GEOMETRIES))
@pytest.mark.parametrize("shape", [(64, 64), (100, 60)])
def test_rasterize_geometries_equals_the_jax_packages(case, shape):
    geometries, values = GEOMETRIES[case]
    bbox = tdc.BBox(north=1.0, south=0.0, east=1.0, west=0.0)
    ours = rasterize.rasterize_geometries(geometries, values, bbox, shape=shape, line_thickness=2)
    theirs = jras.rasterize_geometries(geometries, values, jdc.BBox(*bbox), shape=shape, line_thickness=2)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == np.uint8 and ours.any()
    assert rasterize.unlabeled_fraction(ours) == jras.unlabeled_fraction(theirs)


def test_lonlat_to_pixel_equals_the_jax_packages():
    bbox = tdc.BBox(north=10.0, south=0.0, east=20.0, west=0.0)
    coords = np.random.default_rng(0).uniform(-5, 25, size=(50, 2))
    np.testing.assert_array_equal(rasterize.lonlat_to_pixel(coords, bbox, (100, 200)),
                                  jras.lonlat_to_pixel(coords, jdc.BBox(*bbox), (100, 200)))
    np.testing.assert_allclose(rasterize.lonlat_to_pixel(np.array([[0.0, 10.0], [20.0, 0.0]]), bbox, (100, 200)),
                               [[0, 0], [200, 100]])


def test_resume_protocol_writes_the_jax_packages_files(tmp_path):
    """Both packages' ResumeState, driven alike, write the same files byte
    for byte, read each other's, and refuse a changed setting."""
    meta = {"aoi": "small", "bands": ["B02"], "num_segments": 6}
    dirs = {"ours": tmp_path / "ours", "theirs": tmp_path / "theirs"}
    for d in dirs.values():
        d.mkdir()
    states = {"ours": ResumeState(dirs["ours"], meta), "theirs": JaxResumeState(dirs["theirs"], meta)}
    for rs in states.values():
        assert rs.load() == set()
        rs.mark_done(3)
        rs.mark_done(1)
    for name in ("resume.json", "metadata.tmp.json"):
        assert (dirs["ours"] / name).read_bytes() == (dirs["theirs"] / name).read_bytes()
    assert ResumeState(dirs["theirs"], meta).load() == JaxResumeState(dirs["ours"], meta).load() == {1, 3}
    with pytest.raises(RuntimeError, match="metadata mismatch"):
        ResumeState(dirs["ours"], {**meta, "aoi": "other"}).load()
    for rs in states.values():
        rs.finalize()
    assert (dirs["ours"] / "metadata.json").read_bytes() == (dirs["theirs"] / "metadata.json").read_bytes()
    assert not (dirs["ours"] / "resume.json").exists() and not (dirs["ours"] / "metadata.tmp.json").exists()
