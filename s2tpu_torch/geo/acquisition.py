"""Acquisition orchestration, segment grids -> fetched GeoTIFF datasets: the port of ``s2tpu/geo/acquisition.py``.

The engine behind the download CLIs (parity: reference download_sentinel.py
/ download_labels.py): segment grid, crash-resume protocol, thread pool,
quality gates, file-naming contract, GeoTIFFs written by the port's own
codec (``geo/tiff.py``). Network fetchers are injected callables, so the
whole pipeline runs offline; the SentinelHub / Overpass fetchers live in
``s2tpu_torch.geo.providers`` (their client libraries, which need
credentials, are imported only when a fetcher is built).

Quality gates (reference semantics, names corrected per SURVEY defect #5):
  * sentinel frames with > 50% zero pixels are dropped (cut-off mosaics);
  * multiclass label rasters with > MAX_UNLABELED unlabeled fraction are
    skipped with a LabelQualityWarning (binary maps always save).
"""

from __future__ import annotations

import concurrent.futures
import typing
import warnings
from pathlib import Path

import numpy as np

from s2tpu_torch.configs.data_config import (
    BANDS,
    LABEL_MAPS,
    MAX_UNLABELED,
    SEGMENT_LENGTH_KM,
    SEGMENT_SIZE,
    TIME_INTERVAL,
    ZERO_FRAME_THRESHOLD,
    AOIs,
    BBox,
    DataDirs,
)
from s2tpu_torch.geo.grid import calculate_segments, pixel_size
from s2tpu_torch.geo.rasterize import unlabeled_fraction
from s2tpu_torch.geo.resume import ResumeState
from s2tpu_torch.geo.tiff import GeoInfo, write_geotiff
from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)

# fetch_fn(segment: BBox, time_interval) -> (H, W, C) int16 array
SentinelFetcher = typing.Callable[[BBox, tuple[str, str]], np.ndarray]
# fetch_fn(segment: BBox) -> (H, W) uint8 label raster
LabelFetcher = typing.Callable[[BBox], np.ndarray]


class LabelQualityWarning(UserWarning):
    pass


def split_time_interval(interval: tuple[str, str], frequency: str) -> list[tuple[str, str]]:
    """Split a (start, end) date range into consecutive sub-intervals."""
    import pandas as pd

    dates = pd.date_range(start=interval[0], end=interval[1], freq=frequency)
    return [
        (a.strftime("%Y-%m-%d"), b.strftime("%Y-%m-%d")) for a, b in zip(dates, dates[1:])
    ]


def _geo_for(segment: BBox) -> GeoInfo:
    px, py = pixel_size(segment, SEGMENT_SIZE)
    return GeoInfo(west=segment.west, north=segment.north, pixel_size_x=px, pixel_size_y=py)


def _run_pool(
    process: typing.Callable[[int, BBox], None],
    segments: list[BBox],
    skip: set[int],
    resume: ResumeState,
    workers: int,
    log_file: Path | None = None,
) -> None:
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {
            pool.submit(process, i, seg): i for i, seg in enumerate(segments) if i not in skip
        }
        for fut in concurrent.futures.as_completed(futures):
            idx = futures[fut]
            try:
                fut.result()
                resume.mark_done(idx)
            except Exception as e:  # noqa: BLE001 — log + re-raise (reference behavior)
                msg = f"Error in segment {idx}: {e}"
                logger.error(msg)
                if log_file is not None:
                    with log_file.open("a") as f:
                        f.write(msg + "\n")
                raise


def download_sentinel(
    aoi: str,
    fetch_fn: SentinelFetcher,
    frequency: str = "QS",
    workers: int = 1,
    resume: bool = False,
    data_dir: str | Path | None = None,
    segments: list[BBox] | None = None,
    bands: list[str] | None = None,
) -> int:
    """Fetch time-composited multispectral segments -> sentinel/<seg>_<t>.tif.

    ``bands`` records the band set the fetcher was built with (resume
    metadata + the dataset's channel contract); default the 6 Prithvi-HLS
    bands."""
    if segments is None:
        segments = calculate_segments(AOIs[aoi], SEGMENT_LENGTH_KM)
    intervals = split_time_interval(TIME_INTERVAL, frequency)
    if not intervals:
        raise ValueError(f"frequency {frequency!r} splits {TIME_INTERVAL} into no interval")
    data_dirs = DataDirs(aoi=aoi, map_type="", data_dir=data_dir)
    data_dirs.sentinel.mkdir(parents=True, exist_ok=True)
    metadata = {
        "aoi": aoi,
        "bands": bands if bands is not None else BANDS,
        "frequency": frequency,
        "interval": list(TIME_INTERVAL),
        "num_segments": len(segments),
        "resolution": list(SEGMENT_SIZE),
        "segment_length_km": SEGMENT_LENGTH_KM,
    }
    rs = ResumeState(data_dirs.base_path, metadata)
    skip = rs.load() if resume else set()

    def process(idx: int, segment: BBox) -> None:
        frames: list[np.ndarray] = []
        for interval in intervals:
            data = fetch_fn(segment, interval)  # (H, W, C)
            if (data == 0).sum() > ZERO_FRAME_THRESHOLD * data.size:
                continue  # cut-off mosaic
            frames.append(data)
        geo = _geo_for(segment)
        for t, frame in enumerate(frames):
            write_geotiff(
                data_dirs.sentinel / f"{idx}_{t}.tif",
                np.ascontiguousarray(frame.transpose(2, 0, 1)).astype(np.int16),
                geo=geo,
            )

    _run_pool(process, segments, skip, rs, workers)
    rs.finalize()
    n = len(data_dirs.sentinel_files)
    logger.info(f"Collected {n} sentinel images for AOI {aoi!r}")
    return n


def download_labels(
    aoi: str,
    label_map: str,
    fetch_fn: LabelFetcher,
    workers: int = 1,
    resume: bool = False,
    data_dir: str | Path | None = None,
    segments: list[BBox] | None = None,
) -> int:
    """Fetch/rasterize label segments -> label/<map>/<seg>.tif with quality gate."""
    if segments is None:
        segments = calculate_segments(AOIs[aoi], SEGMENT_LENGTH_KM)
    lm = LABEL_MAPS[label_map]
    data_dirs = DataDirs(aoi=aoi, map_type=label_map, data_dir=data_dir)
    data_dirs.label.mkdir(parents=True, exist_ok=True)
    metadata = {"aoi": aoi, "label_map": lm.name, "num_segments": len(segments)}
    rs = ResumeState(data_dirs.base_path, metadata)
    skip = rs.load() if resume else set()
    # Quality gate applies to multiclass maps; binary maps save regardless
    # (reference net behavior, download_labels.py:160-161, 212-214).
    enforce_gate = lm.num_classes > 2

    def process(idx: int, segment: BBox) -> None:
        raster = fetch_fn(segment)  # (H, W) uint8
        frac = unlabeled_fraction(raster)
        if enforce_gate and frac > MAX_UNLABELED:
            warnings.warn(
                f"segment {idx}: {frac:.1%} unlabeled > {MAX_UNLABELED:.0%} — skipped",
                LabelQualityWarning,
                stacklevel=2,
            )
            return
        write_geotiff(data_dirs.label / f"{idx}.tif", raster.astype(np.uint8), geo=_geo_for(segment))

    _run_pool(process, segments, skip, rs, workers)
    rs.finalize()
    n = len(data_dirs.label_files)
    logger.info(f"Collected {n} label rasters for AOI {aoi!r} map {label_map!r}")
    return n
