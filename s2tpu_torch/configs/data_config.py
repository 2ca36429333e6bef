"""Bands, segment geometry, the label-map registry and the on-disk layout.

The port's copy of the parts of ``s2tpu/configs/data_config.py`` that
serving reads: the band sets, the segment size, the label maps and the file
contract (``sentinel/<segment>_<timeidx>.tif`` and
``label/<type>/<segment>.tif``). AOI boxes, acquisition gates and
evalscripts wait for the acquisition CLIs.
"""

from __future__ import annotations

import typing
from dataclasses import dataclass
from pathlib import Path

from s2tpu_torch.configs import cnes_labels, osm_labels
from s2tpu_torch.configs.paths import DATA_DIR

# The AOI names of the JAX package's ``AOIs`` (their boxes serve acquisition,
# which is not ported); the training CLI takes one of them.
AOI_NAMES: tuple[str, ...] = ("vie", "test", "at", "small", "fr", "fr-lyon", "fr-test")

BANDS: list[str] = ["B02", "B03", "B04", "B8A", "B11", "B12"]  # 10/20 m bands used by Prithvi-HLS
# Every Sentinel-2 L2A surface-reflectance band (L2A has no B10 — cirrus is
# atmospherically corrected away). BASELINE config #3 trains on all 12.
BANDS_ALL12: list[str] = [
    "B01", "B02", "B03", "B04", "B05", "B06", "B07", "B08", "B8A", "B09", "B11", "B12",
]
# Named band sets accepted by DatasetConfig.bands / --bands.
BAND_SETS: dict[str, list[str]] = {"default": BANDS, "all12": BANDS_ALL12}


def parse_bands(spec: "str | list[str]") -> list[str]:
    """Band-set spec -> explicit band list.

    Accepts a BAND_SETS name ('default', 'all12'), a comma-separated band
    list ('B02,B03,B04'), or an already-explicit list. Unknown band names
    raise (typos must not silently change the channel contract)."""
    if isinstance(spec, str):
        spec = BAND_SETS[spec] if spec in BAND_SETS else [b.strip() for b in spec.split(",") if b.strip()]
    bands = list(spec)
    unknown = [b for b in bands if b not in BANDS_ALL12]
    if unknown:
        raise ValueError(f"unknown Sentinel-2 L2A bands {unknown}; valid: {BANDS_ALL12}")
    if not bands:
        raise ValueError("empty band list")
    return bands


class BandsMixin:
    """Shared band-set handling for dataset configs (segmentation + MAE):
    parse the ``bands`` spec at construction, lazily re-parse after a
    post-init mutation with a set name, and derive ``in_channels``."""

    def __post_init__(self) -> None:
        self.bands = parse_bands(self.bands)

    @property
    def in_channels(self) -> int:
        if isinstance(self.bands, str):  # post-init mutation with a set name
            self.bands = parse_bands(self.bands)
        return len(self.bands)


SEGMENT_SIZE: tuple[int, int] = (512, 512)  # pixels per segment side


LabelClass = osm_labels.OsmClass | cnes_labels.CnesClass


@dataclass(frozen=True)
class LabelMap:
    """A named land-cover taxonomy: ordered classes (index 0 = background)."""

    name: str
    classes: tuple[LabelClass, ...]
    source: typing.Literal["osm", "cnes"]

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def class_names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.classes)

    @property
    def colors(self) -> tuple[str, ...]:
        return tuple(c.color for c in self.classes)

    def remap_lut(self):
        """uint8 LUT for raw-raster -> class-index remapping, or None (identity)."""
        return cnes_labels.cnes_remap_lut(self.name, self.classes)


def _cnes_full_with_background() -> tuple[LabelClass, ...]:
    # Raster values are 1..23; prepend a background entry so index==raster value.
    return (cnes_labels.CnesClass("other", "#000000"), *cnes_labels.CNES_FULL)


LABEL_MAPS: dict[str, LabelMap] = {
    "osm-multiclass": LabelMap("osm-multiclass", osm_labels.OSM_MULTICLASS, "osm"),
    "osm-impervious-binary": LabelMap("osm-impervious-binary", osm_labels.OSM_BINARY_IMPERVIOUS, "osm"),
    "osm-nature-binary": LabelMap("osm-nature-binary", osm_labels.OSM_BINARY_NATURE, "osm"),
    "osm-agriculture-binary": LabelMap("osm-agriculture-binary", osm_labels.OSM_BINARY_AGRICULTURE, "osm"),
    "cnes-full": LabelMap("cnes-full", _cnes_full_with_background(), "cnes"),
    "cnes-multiclass": LabelMap("cnes-multiclass", cnes_labels.CNES_SIMPLIFIED_MULTICLASS, "cnes"),
    "cnes-impervious-binary": LabelMap(
        "cnes-impervious-binary", cnes_labels.CNES_SIMPLIFIED_BINARY_IMPERVIOUS, "cnes"
    ),
    "cnes-nature-binary": LabelMap("cnes-nature-binary", cnes_labels.CNES_SIMPLIFIED_BINARY_NATURE, "cnes"),
    "cnes-agriculture-binary": LabelMap(
        "cnes-agriculture-binary", cnes_labels.CNES_SIMPLIFIED_BINARY_AGRICULTURE, "cnes"
    ),
}


class DataDirs:
    """Resolves the on-disk layout for one AOI + label-map combination.

    File contract (same as reference data_config.py:39-56):
      ``<DATA_DIR>/<aoi>/sentinel/<segment>_<timeidx>.tif``  (6-band INT16)
      ``<DATA_DIR>/<aoi>/label/<map_type>/<segment>.tif``    (1-band UINT8)
    Simplified CNES maps read the on-disk ``cnes-full`` rasters and remap at
    load time.
    """

    def __init__(self, aoi: str, map_type: str, data_dir: Path | None = None) -> None:
        root = Path(data_dir) if data_dir is not None else DATA_DIR
        self.base_path: Path = root / aoi
        self.sentinel: Path = self.base_path / "sentinel"
        if "cnes" in map_type:
            map_type = "cnes-full"
        self.label: Path = self.base_path / "label" / map_type

    @property
    def sentinel_files(self) -> dict[int, Path]:
        files = sorted(self.sentinel.glob("*.tif"), key=lambda p: tuple(map(int, p.stem.split("_"))))
        return dict(enumerate(files))

    @property
    def label_files(self) -> dict[int, Path]:
        return {int(p.stem): p for p in sorted(self.label.glob("*.tif"), key=lambda p: int(p.stem))}
