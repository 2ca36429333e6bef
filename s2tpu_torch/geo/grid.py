"""AOI segmentation grid: the port of ``s2tpu/geo/grid.py``.

An AOI's WGS84 bbox splits into ~5.12 km square segments, lon-major (the
reference's ``download_sentinel.py:195-223``), and a segment's pixel size
(``:265-268``). The edges are measured as WGS84 geodesics, solved with
Vincenty's inverse method (accurate to under 1 mm for the sub-3000 km AOI
edges involved, far inside the tolerance of the ceil() that consumes it),
so no geodesy package is needed.
"""

from __future__ import annotations

import math

from s2tpu_torch.configs.data_config import BBox

_WGS84_A = 6378137.0  # semi-major axis (m)
_WGS84_F = 1.0 / 298.257223563  # flattening
_WGS84_B = _WGS84_A * (1.0 - _WGS84_F)


def geodesic_km(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
    """WGS84 geodesic distance in kilometers (Vincenty inverse)."""
    if lat1 == lat2 and lon1 == lon2:
        return 0.0
    L = math.radians(lon2 - lon1)
    u1 = math.atan((1 - _WGS84_F) * math.tan(math.radians(lat1)))
    u2 = math.atan((1 - _WGS84_F) * math.tan(math.radians(lat2)))
    sin_u1, cos_u1 = math.sin(u1), math.cos(u1)
    sin_u2, cos_u2 = math.sin(u2), math.cos(u2)

    lam = L
    for _ in range(200):
        sin_lam, cos_lam = math.sin(lam), math.cos(lam)
        sin_sigma = math.sqrt(
            (cos_u2 * sin_lam) ** 2 + (cos_u1 * sin_u2 - sin_u1 * cos_u2 * cos_lam) ** 2
        )
        if sin_sigma == 0.0:
            return 0.0
        cos_sigma = sin_u1 * sin_u2 + cos_u1 * cos_u2 * cos_lam
        sigma = math.atan2(sin_sigma, cos_sigma)
        sin_alpha = cos_u1 * cos_u2 * sin_lam / sin_sigma
        cos2_alpha = 1.0 - sin_alpha**2
        cos_2sigma_m = 0.0 if cos2_alpha == 0.0 else cos_sigma - 2.0 * sin_u1 * sin_u2 / cos2_alpha
        C = _WGS84_F / 16.0 * cos2_alpha * (4.0 + _WGS84_F * (4.0 - 3.0 * cos2_alpha))
        lam_prev = lam
        lam = L + (1.0 - C) * _WGS84_F * sin_alpha * (
            sigma + C * sin_sigma * (cos_2sigma_m + C * cos_sigma * (-1.0 + 2.0 * cos_2sigma_m**2))
        )
        if abs(lam - lam_prev) < 1e-12:
            break

    u_sq = cos2_alpha * (_WGS84_A**2 - _WGS84_B**2) / _WGS84_B**2
    A = 1.0 + u_sq / 16384.0 * (4096.0 + u_sq * (-768.0 + u_sq * (320.0 - 175.0 * u_sq)))
    B = u_sq / 1024.0 * (256.0 + u_sq * (-128.0 + u_sq * (74.0 - 47.0 * u_sq)))
    delta_sigma = (
        B
        * sin_sigma
        * (
            cos_2sigma_m
            + B
            / 4.0
            * (
                cos_sigma * (-1.0 + 2.0 * cos_2sigma_m**2)
                - B
                / 6.0
                * cos_2sigma_m
                * (-3.0 + 4.0 * sin_sigma**2)
                * (-3.0 + 4.0 * cos_2sigma_m**2)
            )
        )
    )
    return _WGS84_B * A * (sigma - delta_sigma) / 1000.0


def calculate_segments(bbox: BBox, segment_size_km: float) -> list[BBox]:
    """Split an AOI into a lon-major grid of ~segment_size_km square bboxes.

    Iteration order (lon outer, lat inner, both ascending) defines segment
    indices and therefore the on-disk file naming — must stay stable.
    """
    km_width = geodesic_km(bbox.north, bbox.west, bbox.north, bbox.east)
    km_height = geodesic_km(bbox.north, bbox.west, bbox.south, bbox.west)

    num_lon = int(math.ceil(km_width / segment_size_km))
    num_lat = int(math.ceil(km_height / segment_size_km))

    lon_inc = (bbox.east - bbox.west) / num_lon
    lat_inc = (bbox.north - bbox.south) / num_lat

    segments: list[BBox] = []
    for i in range(num_lon):
        west = bbox.west + i * lon_inc
        for j in range(num_lat):
            south = bbox.south + j * lat_inc
            segments.append(BBox(north=south + lat_inc, south=south, east=west + lon_inc, west=west))
    return segments


def pixel_size(bbox: BBox, resolution: tuple[int, int]) -> tuple[float, float]:
    """Degrees per pixel for a segment rendered at `resolution` (w, h)."""
    return (bbox.east - bbox.west) / resolution[0], (bbox.north - bbox.south) / resolution[1]
