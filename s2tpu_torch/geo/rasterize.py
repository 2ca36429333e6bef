"""Vector -> raster burning for OSM label generation: the port of ``s2tpu/geo/rasterize.py``.

The reference rasterizes OSM GeoDataFrames with rasterio.features.rasterize
(download_labels.py:203-227); this burns with cv2.fillPoly (C++-speed
polygon scan conversion), with no GDAL: geometries come in as GeoJSON-style
mappings (``__geo_interface__``, what osmnx/geopandas geometries expose),
are transformed from WGS84 degrees to pixel coordinates, and are burned in
class order so later classes overwrite earlier ones (the reference's
priority rule, osm_label_mapping.py:11-12). cv2 is imported inside
:func:`rasterize_geometries`: the module imports without it.
"""

from __future__ import annotations

import typing

import numpy as np

from s2tpu_torch.configs.data_config import BBox


def lonlat_to_pixel(
    coords: np.ndarray, bbox: BBox, shape: tuple[int, int]
) -> np.ndarray:
    """(N, 2) lon/lat -> (N, 2) x/y pixel coords (row 0 = bbox.north)."""
    h, w = shape
    x = (coords[:, 0] - bbox.west) / (bbox.east - bbox.west) * w
    y = (bbox.north - coords[:, 1]) / (bbox.north - bbox.south) * h
    return np.stack([x, y], axis=1)


def _rings(geom: dict) -> typing.Iterator[tuple[list, list]]:
    """Yield (exterior, holes) coordinate rings from a GeoJSON geometry."""
    gtype = geom["type"]
    if gtype == "Polygon":
        rings = geom["coordinates"]
        if rings:
            yield rings[0], rings[1:]
    elif gtype == "MultiPolygon":
        for poly in geom["coordinates"]:
            if poly:
                yield poly[0], poly[1:]
    elif gtype == "GeometryCollection":
        for sub in geom.get("geometries", []):
            yield from _rings(sub)
    # Points / LineStrings: burned separately (see rasterize_geometries)


def rasterize_geometries(
    geometries: typing.Sequence[dict],
    values: typing.Sequence[int],
    bbox: BBox,
    shape: tuple[int, int] = (512, 512),
    fill: int = 0,
    line_thickness: int = 1,
) -> np.ndarray:
    """Burn GeoJSON geometries into a uint8 raster, later entries win.

    Polygons fill (holes cut out); LineStrings stroke with ``line_thickness``;
    Points burn single pixels — matching rasterio's all-touched=False default
    closely enough for label parity at 10 m resolution.
    """
    import cv2

    out = np.full(shape, fill, dtype=np.uint8)
    for geom, value in zip(geometries, values):
        gtype = geom["type"]
        if gtype in ("Polygon", "MultiPolygon", "GeometryCollection"):
            exteriors, holes = [], []
            for ext, hs in _rings(geom):
                exteriors.append(ext)
                holes.extend(hs)
            for ring_set, v in ((exteriors, value), (holes, fill)):
                polys = [
                    np.round(lonlat_to_pixel(np.asarray(r, np.float64), bbox, shape)).astype(np.int32)
                    for r in ring_set
                    if len(r) >= 3
                ]
                if polys:
                    cv2.fillPoly(out, polys, int(v))
        elif gtype in ("LineString", "MultiLineString"):
            lines = geom["coordinates"] if gtype == "MultiLineString" else [geom["coordinates"]]
            for line in lines:
                pts = np.round(
                    lonlat_to_pixel(np.asarray(line, np.float64), bbox, shape)
                ).astype(np.int32)
                cv2.polylines(out, [pts], isClosed=False, color=int(value), thickness=line_thickness)
        elif gtype in ("Point", "MultiPoint"):
            pts = geom["coordinates"] if gtype == "MultiPoint" else [geom["coordinates"]]
            for pt in pts:
                xy = np.round(lonlat_to_pixel(np.asarray([pt], np.float64), bbox, shape)).astype(int)[0]
                if 0 <= xy[1] < shape[0] and 0 <= xy[0] < shape[1]:
                    out[xy[1], xy[0]] = value
    return out


def unlabeled_fraction(raster: np.ndarray, fill: int = 0) -> float:
    return float((raster == fill).mean())
