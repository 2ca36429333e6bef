"""Network data providers, SentinelHub (imagery + CNES rasters) and OSM Overpass: the port of ``s2tpu/geo/providers.py``.

sentinelhub and osmnx are credentialed client libraries the port does not
require: each is imported when its fetcher is built, and a missing one
raises an error that says what to install. Each factory returns a fetcher
for ``s2tpu_torch.geo.acquisition``.

Parity: reference download_sentinel.py:226-244 (L2A request, maxcc,
LEAST_CC mosaicking, bicubic upsampling), download_labels.py:164-200 (osmnx
features_from_bbox per class, priority by class order) and :230-262 (CNES
BYOC collection, keep OCS band only).
"""

from __future__ import annotations

import os
import time

import numpy as np

from s2tpu_torch.configs.data_config import (
    BANDS,
    CNES_BYOC_COLLECTION_ID,
    CNES_LABEL_EVALSCRIPT,
    LABEL_MAPS,
    MAX_CLOUD_COVER,
    SEGMENT_SIZE,
    BBox,
    sentinel2_evalscript,
)
from s2tpu_torch.geo.rasterize import rasterize_geometries


def _sh_config():
    try:
        import sentinelhub as sh
    except ImportError as e:
        raise RuntimeError(
            "sentinelhub is not installed — `pip install sentinelhub` and set "
            "SH_CLIENT_ID / SH_CLIENT_SECRET to enable downloads"
        ) from e
    return sh, sh.SHConfig(
        sh_client_id=os.getenv("SH_CLIENT_ID"), sh_client_secret=os.getenv("SH_CLIENT_SECRET")
    )


def sentinel_fetcher(rate_limit_sleep: float = 2.0, bands: list[str] | None = None):
    """SentinelHub L2A fetcher: (segment, interval) -> (H, W, C) int16.

    ``bands`` selects the spectral bands (raster band order); default is the
    6 Prithvi-HLS bands (reference data_config.py:72). BASELINE config #3
    trains on BANDS_ALL12."""
    sh, config = _sh_config()
    evalscript = sentinel2_evalscript(bands if bands is not None else BANDS)

    def fetch(segment: BBox, interval: tuple[str, str]) -> np.ndarray:
        request = sh.SentinelHubRequest(
            evalscript=evalscript,
            input_data=[
                sh.SentinelHubRequest.input_data(
                    data_collection=sh.DataCollection.SENTINEL2_L2A,
                    time_interval=interval,
                    maxcc=MAX_CLOUD_COVER,
                    mosaicking_order=sh.MosaickingOrder.LEAST_CC,
                    upsampling=sh.ResamplingType.BICUBIC,
                )
            ],
            responses=[sh.SentinelHubRequest.output_response("default", sh.MimeType.TIFF)],
            bbox=sh.BBox((segment.west, segment.south, segment.east, segment.north), crs=sh.CRS.WGS84),
            size=SEGMENT_SIZE,
            config=config,
        )
        data = request.get_data(save_data=False)[0]
        time.sleep(rate_limit_sleep)
        return np.asarray(data)

    return fetch


def cnes_label_fetcher(rate_limit_sleep: float = 2.0):
    """CNES Land Cover BYOC fetcher: segment -> (H, W) uint8 OCS raster.

    Drops the OCS_Confidence / OCS_Validity bands (reference keeps band 0,
    download_labels.py:247-262).
    """
    sh, config = _sh_config()
    collection = sh.DataCollection.define_byoc(CNES_BYOC_COLLECTION_ID)

    def fetch(segment: BBox) -> np.ndarray:
        request = sh.SentinelHubRequest(
            evalscript=CNES_LABEL_EVALSCRIPT,
            input_data=[sh.SentinelHubRequest.input_data(data_collection=collection)],
            responses=[sh.SentinelHubRequest.output_response("default", sh.MimeType.TIFF)],
            bbox=sh.BBox((segment.west, segment.south, segment.east, segment.north), crs=sh.CRS.WGS84),
            size=SEGMENT_SIZE,
            config=config,
        )
        data = np.asarray(request.get_data(save_data=False)[0])
        time.sleep(rate_limit_sleep)
        return data[..., 0]  # OCS band only

    return fetch


def osm_label_fetcher(label_map: str):
    """OSM Overpass fetcher: segment -> (H, W) uint8 rasterized class map.

    Queries osmnx per class; later classes burn over earlier ones (class
    order = priority, the reference's dict-order rule).
    """
    try:
        import osmnx as ox
    except ImportError as e:
        raise RuntimeError("osmnx is not installed — `pip install osmnx` to fetch OSM labels") from e

    lm = LABEL_MAPS[label_map]
    if lm.source != "osm":
        raise ValueError(f"{label_map} is not an OSM taxonomy")

    def fetch(segment: BBox) -> np.ndarray:
        geometries: list[dict] = []
        values: list[int] = []
        for class_idx, cls in enumerate(lm.classes):
            if not cls.tags:
                continue  # background
            try:
                gdf = ox.features.features_from_bbox(
                    bbox=(segment.west, segment.south, segment.east, segment.north), tags=dict(cls.tags)
                )
            except Exception:  # no features in this segment
                continue
            for geom in gdf.geometry:
                if geom is None:
                    continue
                geometries.append(geom.__geo_interface__)
                values.append(class_idx)
        return rasterize_geometries(geometries, values, segment, SEGMENT_SIZE)

    return fetch
