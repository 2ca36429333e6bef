"""AOIs, bands, segment geometry, acquisition gates, the label-map registry and the on-disk layout.

The port's copy of ``s2tpu/configs/data_config.py``: the AOI bounding
boxes, the band sets, the time interval, the segment geometry, the quality
gates, the label maps, the file contract
(``sentinel/<segment>_<timeidx>.tif`` and ``label/<type>/<segment>.tif``)
and the SentinelHub evalscripts the acquisition CLIs send.
"""

from __future__ import annotations

import json
import typing
from dataclasses import dataclass
from pathlib import Path

from s2tpu_torch.configs import cnes_labels, osm_labels
from s2tpu_torch.configs.paths import DATA_DIR


class BBox(typing.NamedTuple):
    """Geographic bounding box in WGS84 degrees."""

    north: float
    south: float
    east: float
    west: float

    def __str__(self) -> str:
        return f"(N: {self.north}, S: {self.south}, E: {self.east}, W: {self.west})"


AOIs: dict[str, BBox] = {
    "vie": BBox(north=48.341646, south=47.739323, east=16.567383, west=15.117188),
    "test": BBox(north=48.980217, south=46.845164, east=17.116699, west=13.930664),
    "at": BBox(north=49.009121, south=46.439861, east=17.523438, west=9.008164),
    "small": BBox(north=48.286391, south=48.195845, east=16.463699, west=16.311951),
    # CNES AOIs must stay inside France (no sea) so raster value 0 is unambiguous.
    "fr": BBox(north=49.2834, south=43.4828, east=5.9551, west=-0.9523),
    "fr-lyon": BBox(north=45.897655, south=45.477466, east=5.284424, west=4.508514),
    "fr-test": BBox(north=49.549043, south=49.381467, east=0.155069, west=-0.203631),
}
AOI_NAMES: tuple[str, ...] = tuple(AOIs)  # what the CLIs take

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


EPSG_WGS84: int = 4326
TIME_INTERVAL: tuple[str, str] = ("2020-01-01", "2021-01-01")
SEGMENT_SIZE: tuple[int, int] = (512, 512)  # pixels per segment side
SEGMENT_LENGTH_KM: float = 5.12  # 512 px * 10 m
MAX_CLOUD_COVER: float = 0.05
MAX_UNLABELED: float = 0.05  # label-quality gate: max fraction of unlabeled pixels
ZERO_FRAME_THRESHOLD: float = 0.5  # drop a composite frame if > this fraction is 0
CNES_BYOC_COLLECTION_ID: str = "9baa2732-6010-49e2-a75f-7b6f6930d4ad"


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


def sentinel2_evalscript(bands: list[str] | None = None) -> str:
    """SentinelHub v3 evalscript: raw DN INT16 for the configured bands."""
    bands = bands if bands is not None else BANDS
    sample_expr = ", ".join(f"sample.{b}" for b in bands)
    return f"""//VERSION=3
function setup() {{
    return {{
        input: [{{ bands: {json.dumps(bands)}, units: "DN" }}],
        output: {{ bands: {len(bands)}, sampleType: "INT16" }}
    }};
}}
function evaluatePixel(sample) {{
    return [{sample_expr}];
}}
"""


CNES_LABEL_EVALSCRIPT: str = """//VERSION=3
function setup() {
    return {
        input: [{"bands": ["OCS", "OCS_Confidence", "OCS_Validity"], "units": "DN"}],
        output: {bands: 3, sampleType: "UINT8"}
    };
}
function evaluatePixel(sample) {
    return [sample.OCS, sample.OCS_Confidence, sample.OCS_Validity];
}
"""
