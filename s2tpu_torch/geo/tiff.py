"""Minimal self-contained GeoTIFF codec.

The reference delegates raster IO to rasterio/GDAL (s2osm_dataset.py:52-56,
download_sentinel.py:247-262). That stack is not part of this image, and the
file contract is fully under our control (we write the segments ourselves),
so this module implements exactly the subset needed — little-endian baseline
TIFF, strip-based, uncompressed or DEFLATE, uint8/int16/uint16/float32,
chunky or planar interleave, with the GeoTIFF tags (pixel scale, tiepoint,
EPSG geokey) that make outputs ingestible by GDAL/QGIS. If rasterio IS
installed it is used transparently for reading foreign files.

Arrays are (C, H, W) on the API surface, matching the reference's band-first
on-disk contract.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_SAMPLE_FORMAT = 339
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_GEO_KEY_DIRECTORY = 34735

_TYPE_SHORT = 3
_TYPE_LONG = 4
_TYPE_DOUBLE = 12

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}

_SF_UNSIGNED, _SF_SIGNED, _SF_FLOAT = 1, 2, 3

_DTYPE_TO_SF = {
    np.dtype(np.uint8): (_SF_UNSIGNED, 8),
    np.dtype(np.uint16): (_SF_UNSIGNED, 16),
    np.dtype(np.int16): (_SF_SIGNED, 16),
    np.dtype(np.float32): (_SF_FLOAT, 32),
}


@dataclass
class GeoInfo:
    """Affine north-up georeferencing: origin = top-left corner (WGS84 deg)."""

    west: float
    north: float
    pixel_size_x: float
    pixel_size_y: float
    epsg: int = 4326

    @property
    def east(self) -> float:
        return self.west  # placeholder; width-dependent, see bounds()

    def bounds(self, width: int, height: int) -> tuple[float, float, float, float]:
        """(west, south, east, north)."""
        return (
            self.west,
            self.north - self.pixel_size_y * height,
            self.west + self.pixel_size_x * width,
            self.north,
        )


def write_geotiff(
    path: str | Path,
    data: np.ndarray,
    geo: GeoInfo | None = None,
    compress: bool = False,
) -> None:
    """Write (C, H, W) or (H, W) array as a GeoTIFF (planar interleave)."""
    if data.ndim == 2:
        data = data[None]
    assert data.ndim == 3, f"expected (C,H,W), got {data.shape}"
    data = np.ascontiguousarray(data)
    if data.dtype not in _DTYPE_TO_SF:
        raise ValueError(f"unsupported dtype {data.dtype}")
    sample_format, bits = _DTYPE_TO_SF[data.dtype]
    c, h, w = data.shape

    # One strip per band (planar config 2: bands stored separately).
    strips: list[bytes] = []
    for band in range(c):
        raw = data[band].tobytes()
        strips.append(zlib.compress(raw, 6) if compress else raw)

    entries: list[tuple[int, int, int, bytes | int]] = []  # (tag, type, count, value)

    def entry(tag: int, typ: int, values) -> None:
        if not isinstance(values, (list, tuple)):
            values = [values]
        fmt = {_TYPE_SHORT: "H", _TYPE_LONG: "I", _TYPE_DOUBLE: "d"}[typ]
        payload = struct.pack(f"<{len(values)}{fmt}", *values)
        entries.append((tag, typ, len(values), payload))

    entry(_IMAGE_WIDTH, _TYPE_LONG, w)
    entry(_IMAGE_LENGTH, _TYPE_LONG, h)
    entry(_BITS_PER_SAMPLE, _TYPE_SHORT, [bits] * c)
    entry(_COMPRESSION, _TYPE_SHORT, 8 if compress else 1)
    entry(_PHOTOMETRIC, _TYPE_SHORT, 1)  # BlackIsZero
    entry(_SAMPLES_PER_PIXEL, _TYPE_SHORT, c)
    entry(_ROWS_PER_STRIP, _TYPE_LONG, h)
    entry(_STRIP_BYTE_COUNTS, _TYPE_LONG, [len(s) for s in strips])
    entry(_PLANAR_CONFIG, _TYPE_SHORT, 2)
    entry(_SAMPLE_FORMAT, _TYPE_SHORT, [sample_format] * c)
    if geo is not None:
        entry(_MODEL_PIXEL_SCALE, _TYPE_DOUBLE, [geo.pixel_size_x, geo.pixel_size_y, 0.0])
        entry(_MODEL_TIEPOINT, _TYPE_DOUBLE, [0.0, 0.0, 0.0, geo.west, geo.north, 0.0])
        # GeoKeyDirectory: version 1.1.0, 3 keys: model type=geographic(2),
        # raster type=PixelIsArea(1), geographic CRS = epsg.
        entry(
            _GEO_KEY_DIRECTORY,
            _TYPE_SHORT,
            [1, 1, 0, 3, 1024, 0, 1, 2, 1025, 0, 1, 1, 2048, 0, 1, geo.epsg],
        )

    # StripOffsets placeholder, patched after layout is known.
    entry(_STRIP_OFFSETS, _TYPE_LONG, [0] * c)
    entries.sort(key=lambda e: e[0])

    header_size = 8
    ifd_size = 2 + len(entries) * 12 + 4
    # Out-of-line values go after the IFD.
    overflow_offset = header_size + ifd_size
    overflow: list[bytes] = []
    packed_entries: list[bytes] = []
    strip_offsets_patch: int | None = None
    for tag, typ, count, payload in entries:
        size = count * _TYPE_SIZES[typ]
        if size <= 4:
            value_field = payload.ljust(4, b"\x00")
        else:
            value_field = struct.pack("<I", overflow_offset)
            if tag == _STRIP_OFFSETS:
                strip_offsets_patch = overflow_offset
            overflow.append(payload)
            overflow_offset += size
        packed_entries.append(struct.pack("<HHI", tag, typ, count) + value_field)

    data_offset = overflow_offset
    offsets = []
    pos = data_offset
    for s in strips:
        offsets.append(pos)
        pos += len(s)

    offsets_payload = struct.pack(f"<{c}I", *offsets)
    if strip_offsets_patch is None:
        # Offsets fit inline (c==1): regenerate that entry.
        for i, (tag, typ, count, _payload) in enumerate(entries):
            if tag == _STRIP_OFFSETS:
                packed_entries[i] = struct.pack("<HHI", tag, typ, count) + offsets_payload.ljust(4, b"\x00")
    else:
        running = header_size + ifd_size
        for i, blob in enumerate(overflow):
            if running == strip_offsets_patch:
                overflow[i] = offsets_payload
            running += len(blob)

    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", header_size))
        f.write(struct.pack("<H", len(entries)))
        f.write(b"".join(packed_entries))
        f.write(struct.pack("<I", 0))  # next IFD
        f.write(b"".join(overflow))
        for s in strips:
            f.write(s)


def _read_with_rasterio(path: str | Path) -> tuple[np.ndarray, GeoInfo | None]:
    """Fallback for foreign TIFFs (exotic compression/layout) when rasterio exists."""
    import rasterio  # optional dependency — only reached on unsupported files

    with rasterio.open(path) as src:
        data = src.read()
        t = src.transform
        geo = GeoInfo(west=t.c, north=t.f, pixel_size_x=t.a, pixel_size_y=-t.e)
    return data, geo


def read_geotiff(path: str | Path) -> tuple[np.ndarray, GeoInfo | None]:
    """Read a TIFF into a (C, H, W) array plus geo metadata (if present).

    Handles the subset this codec writes natively; foreign files that use
    unsupported compression/tiling fall through to rasterio when installed.
    """
    try:
        return _read_geotiff_native(path)
    except (ValueError, KeyError) as native_err:
        try:
            return _read_with_rasterio(path)
        except ImportError:
            raise native_err from None


def _read_geotiff_native(path: str | Path) -> tuple[np.ndarray, GeoInfo | None]:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:2] == b"II":
        bo = "<"
    elif blob[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    magic, ifd_offset = struct.unpack(f"{bo}HI", blob[2:8])
    if magic != 42:
        raise ValueError(f"{path}: bad TIFF magic {magic}")

    (n_entries,) = struct.unpack(f"{bo}H", blob[ifd_offset : ifd_offset + 2])
    tags: dict[int, list] = {}
    for i in range(n_entries):
        off = ifd_offset + 2 + i * 12
        tag, typ, count = struct.unpack(f"{bo}HHI", blob[off : off + 8])
        size = count * _TYPE_SIZES.get(typ, 1)
        if size <= 4:
            payload = blob[off + 8 : off + 8 + size]
        else:
            (ptr,) = struct.unpack(f"{bo}I", blob[off + 8 : off + 12])
            payload = blob[ptr : ptr + size]
        fmt = {_TYPE_SHORT: "H", _TYPE_LONG: "I", _TYPE_DOUBLE: "d", 1: "B", 2: "c", 11: "f"}.get(typ)
        if fmt is None:
            continue
        tags[tag] = list(struct.unpack(f"{bo}{count}{fmt}", payload))

    w = tags[_IMAGE_WIDTH][0]
    h = tags[_IMAGE_LENGTH][0]
    spp = tags.get(_SAMPLES_PER_PIXEL, [1])[0]
    bits = tags.get(_BITS_PER_SAMPLE, [8])[0]
    compression = tags.get(_COMPRESSION, [1])[0]
    planar = tags.get(_PLANAR_CONFIG, [1])[0]
    sample_format = tags.get(_SAMPLE_FORMAT, [_SF_UNSIGNED])[0]
    rows_per_strip = tags.get(_ROWS_PER_STRIP, [h])[0]
    offsets = tags[_STRIP_OFFSETS]
    counts = tags[_STRIP_BYTE_COUNTS]

    dtype = {
        (_SF_UNSIGNED, 8): np.uint8,
        (_SF_UNSIGNED, 16): np.uint16,
        (_SF_SIGNED, 16): np.int16,
        (_SF_FLOAT, 32): np.float32,
    }.get((sample_format, bits))
    if dtype is None:
        raise ValueError(f"{path}: unsupported sample format {sample_format}/{bits}bit")
    dtype = np.dtype(dtype).newbyteorder(bo)

    raw = bytearray()
    for off, cnt in zip(offsets, counts):
        chunk = blob[off : off + cnt]
        if compression == 8 or compression == 32946:  # DEFLATE
            chunk = zlib.decompress(chunk)
        elif compression != 1:
            raise ValueError(f"{path}: unsupported compression {compression}")
        raw.extend(chunk)

    flat = np.frombuffer(bytes(raw), dtype=dtype)
    if planar == 2:
        strips_per_band = (h + rows_per_strip - 1) // rows_per_strip
        assert len(offsets) == spp * strips_per_band or len(offsets) == spp
        data = flat[: spp * h * w].reshape(spp, h, w)
    else:
        data = flat[: h * w * spp].reshape(h, w, spp).transpose(2, 0, 1)
    data = np.ascontiguousarray(data.astype(dtype.newbyteorder("=")))

    geo: GeoInfo | None = None
    if _MODEL_PIXEL_SCALE in tags and _MODEL_TIEPOINT in tags:
        sx, sy = tags[_MODEL_PIXEL_SCALE][0], tags[_MODEL_PIXEL_SCALE][1]
        tie = tags[_MODEL_TIEPOINT]
        epsg = 4326
        if _GEO_KEY_DIRECTORY in tags:
            gk = tags[_GEO_KEY_DIRECTORY]
            for k in range(4, len(gk), 4):
                if gk[k] == 2048:
                    epsg = gk[k + 3]
        geo = GeoInfo(west=tie[3], north=tie[4], pixel_size_x=sx, pixel_size_y=sy, epsg=epsg)
    return data, geo
