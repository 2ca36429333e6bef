"""CNES Land Cover (OSO) taxonomy and simplification remaps.

The CNES map (https://collections.sentinel-hub.com/cnes-land-cover-map/) is a
23-class France-wide raster; raster value 0 means "outside France" and stays 0
(unlabeled) under every remap. Capability parity with reference
src/configs/cnes_labell_mappings.py:15-95, but the remap here is a
precomputed 256-entry lookup table applied with one vectorized gather
(`LUT[labels]`) instead of a per-pixel Python ``np.vectorize`` call — the
same transform at array speed, and directly liftable into the jit'd input
pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CnesClass:
    name: str
    color: str


# Full 23-class nomenclature; raster value = index+1 (value 0 = outside France).
CNES_FULL: tuple[CnesClass, ...] = (
    CnesClass("Dense built-up area", "#ff00ff"),
    CnesClass("Diffuse built-up area", "#ff55ff"),
    CnesClass("Industrial and commercial areas", "#ffaaff"),
    CnesClass("Roads", "#00ffff"),
    CnesClass("Oilseeds (Rapeseed)", "#ffff00"),
    CnesClass("Straw cereals (Wheat, Triticale, Barley)", "#d0ff00"),
    CnesClass("Protein crops (Beans / Peas)", "#a1d600"),
    CnesClass("Soy", "#ffab44"),
    CnesClass("Sunflower", "#d6d600"),
    CnesClass("Corn", "#ff5500"),
    CnesClass("Rice", "#c5ffff"),
    CnesClass("Tubers/roots", "#aaaa61"),
    CnesClass("Grasslands", "#aaaa00"),
    CnesClass("Orchards and fruit growing", "#aaaaff"),
    CnesClass("Vineyards", "#550000"),
    CnesClass("Hardwood forest", "#009c00"),
    CnesClass("Softwood forest", "#003200"),
    CnesClass("Natural grasslands and pastures", "#aaff00"),
    CnesClass("Woody moorlands", "#55aa7f"),
    CnesClass("Natural mineral surfaces", "#ff0000"),
    CnesClass("Beaches and dunes", "#ffb802"),
    CnesClass("Glaciers and eternal snows", "#bebebe"),
    CnesClass("Water", "#0000ff"),
)

_AGRI, _NATURE, _IMPERV = "agriculture", "nature", "impervious_surface"

CNES_SIMPLIFIED_MULTICLASS: tuple[CnesClass, ...] = (
    CnesClass("other", "#000000"),
    CnesClass(_AGRI, "#f5a142"),
    CnesClass(_NATURE, "#00ff00"),
    CnesClass(_IMPERV, "#646464"),
)
CNES_SIMPLIFIED_BINARY_IMPERVIOUS = (CnesClass("other", "#000000"), CnesClass(_IMPERV, "#646464"))
CNES_SIMPLIFIED_BINARY_NATURE = (CnesClass("other", "#000000"), CnesClass(_NATURE, "#00ff00"))
CNES_SIMPLIFIED_BINARY_AGRICULTURE = (CnesClass("other", "#000000"), CnesClass(_AGRI, "#f5a142"))

# Raster value (1..23) -> simplified group. Reference semantics
# (cnes_labell_mappings.py:50-74): built-up/roads -> impervious; crops,
# orchards, vineyards -> agriculture; everything natural (incl. grasslands,
# water, glaciers, beaches) -> nature.
CNES_TO_SIMPLIFIED: dict[int, str] = {
    1: _IMPERV, 2: _IMPERV, 3: _IMPERV, 4: _IMPERV,
    5: _AGRI, 6: _AGRI, 7: _AGRI, 8: _AGRI, 9: _AGRI, 10: _AGRI, 11: _AGRI, 12: _AGRI,
    13: _NATURE,
    14: _AGRI, 15: _AGRI,
    16: _NATURE, 17: _NATURE, 18: _NATURE, 19: _NATURE, 20: _NATURE, 21: _NATURE,
    22: _NATURE, 23: _NATURE,
}


def cnes_remap_lut(label_map_name: str, classes: tuple[CnesClass, ...]) -> np.ndarray | None:
    """Build a uint8 LUT remapping raw CNES raster values to target indices.

    Returns ``None`` for non-CNES maps or the full map (identity — no remap).
    Values not present in the target map (and 0 = outside France) map to 0.
    Apply as ``LUT[labels]``.
    """
    if "cnes" not in label_map_name or label_map_name == "cnes-full":
        return None
    target_names = [c.name for c in classes]
    lut = np.zeros(256, dtype=np.uint8)
    for raw_value, group in CNES_TO_SIMPLIFIED.items():
        if group in target_names:
            lut[raw_value] = target_names.index(group)
    return lut
