"""OpenStreetMap label taxonomy.

Maps OSM tag queries to land-cover class indices. Class index = position of
the class name in the mapping; entry order is also the rasterization
priority: later classes overwrite earlier ones on overlap (capability parity
with reference src/configs/osm_label_mapping.py:11-188, where dict order
determines priority and "other"/index-0 is the unlabeled background).

Tag values follow the osmnx ``features_from_bbox(tags=...)`` convention:
``True`` selects every feature with the key, a list selects specific values.
"""

from __future__ import annotations

from dataclasses import dataclass, field

OSMTagQuery = dict[str, bool | list[str]]


@dataclass(frozen=True)
class OsmClass:
    name: str
    color: str
    tags: OSMTagQuery = field(default_factory=dict)


OTHER = OsmClass(name="other", color="#000000")

AGRICULTURE = OsmClass(
    name="agriculture",
    color="#f5a142",
    tags={
        "crop": True,
        "landuse": [
            "agricultural", "agriculture", "animal_keeping", "farmland", "farmyard",
            "flowerbed", "orchard", "paddy", "salt_pond", "vineyard",
        ],
        "produce": [
            "cocoa", "coffee", "fiber", "flowers", "fruit", "grain", "herbs", "hop",
            "nuts", "oil", "rubber", "spices", "sugar", "tea", "tobacco", "vegetables",
            "vine",
        ],
    },
)

NATURE = OsmClass(
    name="nature",
    color="#00ff00",
    tags={
        "boundary": ["national_park", "protected_area"],
        "landuse": [
            "allotments", "forest", "forestry", "grass", "greenfield", "meadow",
            "mountain_pass", "mountain_ridge", "village_green",
        ],
        "leisure": ["dog_park", "garden", "nature_reserve", "park", "protected_area"],
        "natural": True,
        "region": ["mountain_range", "natural_area"],
        "surface": ["earth", "grass", "mud", "rock", "sand"],
        "waterway": [
            "brook", "canal", "ditch", "drain", "river", "riverbank", "stream",
            "waterfall",
        ],
        "wetland": ["bog", "fen", "marsh", "reedbed", "swamp"],
    },
)

IMPERVIOUS = OsmClass(
    name="impervious_surface",
    color="#646464",
    tags={
        "aeroway": True,
        "amenity": ["parking", "parking_space"],
        "barrier": ["city_wall"],
        "building": True,
        "highway": True,
        "landuse": [
            "airport", "brownfield", "commercial", "construction", "depot", "garages",
            "impervious_surface", "industrial", "landfill", "military", "port",
            "quarry", "residential", "retail",
        ],
        "leisure": ["pitch", "swimming_pool", "track"],
        "man_made": ["bridge", "pier", "tower", "wastewater_plant", "water_works"],
        "power": ["substation", "transformer"],
        "public_transport": ["platform"],
        "railway": True,
        "surface": [
            "asphalt", "cobblestone", "concrete", "metal", "paving_stones", "sett",
            "unhewn_cobblestone",
        ],
        "waterway": ["dock", "lock_gate"],
    },
)

# Class index = position in tuple; index 0 ("other") is background/unlabeled.
OSM_MULTICLASS: tuple[OsmClass, ...] = (OTHER, AGRICULTURE, NATURE, IMPERVIOUS)
OSM_BINARY_IMPERVIOUS: tuple[OsmClass, ...] = (OTHER, IMPERVIOUS)
OSM_BINARY_NATURE: tuple[OsmClass, ...] = (OTHER, NATURE)
OSM_BINARY_AGRICULTURE: tuple[OsmClass, ...] = (OTHER, AGRICULTURE)
