"""Class taxonomy and object-root semantics.

Reproduces the reference's semantic-name -> class-ID map
(``construction_class``, generate_construction_data.py:67-106), the crane
part-child map (110-121), and the object-root/prim-path aggregation rules of
``get_object_root`` (144-233) — including the ``#``-separated virtual crane
part roots (186-187) — so emitted labels carry identical ``class_mapping``,
``class_name``, ``class_id``, and ``prim_path`` values.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# Exact reference dict, same key order (dict order is preserved in the label
# JSON's class_mapping field; generate_construction_data.py:69-106, 2063).
CONSTRUCTION_CLASS: Dict[str, int] = {
    "trafficcone": 0,
    "cone": 0,
    "tree": 1,
    "fence": 2,
    "fencing": 2,
    "construction_site": 2,
    "crane": 3,
    "pk7": 3,
    "cranebase": 6,
    "cranecolumn": 7,
    "craneboom": 8,
    "cranetelescopic": 9,
    "dumper": 4,
    "09684481": 4,
    "human": 5,
    "dhgen": 5,
    "skelroot": 5,
}

# Canonical (first) name per class id, used for label class_name fields.
CLASS_ID_TO_NAME: Dict[int, str] = {
    0: "trafficcone",
    1: "tree",
    2: "fence",
    3: "crane",
    4: "dumper",
    5: "human",
    6: "cranebase",
    7: "cranecolumn",
    8: "craneboom",
    9: "cranetelescopic",
}

NUM_CLASSES = 10

# Crane first-level child name (lowercased) -> (part class name, class id)
# (generate_construction_data.py:110-121).
CRANE_PART_CHILD_MAP: Dict[str, Tuple[str, int]] = {
    "s104gg03a_sw": ("cranebase", 6),
    "s104s01kb_sw": ("cranebase", 6),
    "s104hz01ka_sw": ("cranecolumn", 7),
    "s104h01kb_sw": ("cranecolumn", 7),
    "s104hz02ka_sw": ("cranecolumn", 7),
    "s104kz01ka_sw": ("cranecolumn", 7),
    "tn__s104ekb_as_sw_jj7": ("craneboom", 8),
    "s104kz02ka_sw": ("cranetelescopic", 9),
    "tn__hhk320ka_sw_lg": ("cranetelescopic", 9),
    "tn__hhk319_sw_od": ("cranetelescopic", 9),
}

# Scene-graph root paths of the world2.usd scene
# (generate_construction_data.py:128-141).
CRANE_ROOT = "/World/GroundPlane/tn__Pk7501SLD_PNR3879_fPM"
DUMPER_ROOT = "/World/GroundPlane/tn__09684481_"
HUMAN_ROOT = "/World/GroundPlane/DHGen"
CONE_ROOT_PREFIX = "/World/GroundPlane/Cone001"
TREE_ROOT_PREFIX = "/World/Tree/Tree"
FENCE_ROOT_PREFIX = (
    "/World/GroundPlane/Construction_Site_Construction_Zeppelin_Rental_GmbH_"
    "Metal_Construction_Site_Fencing_height_"
)

OBJECT_ROOT_PATTERNS = [
    FENCE_ROOT_PREFIX,
    CRANE_ROOT,
    DUMPER_ROOT,
    CONE_ROOT_PREFIX,
    HUMAN_ROOT,
    TREE_ROOT_PREFIX,
]

# Keyword fallbacks for crane parts (generate_construction_data.py:202-205).
_CRANE_KEYWORDS = {
    "cranebase": ["base", "chassis", "footer", "support", "grund", "fahrwerk"],
    "cranecolumn": ["column", "turret", "mast", "tower", "saeule", "drehwerk", "oberwagen"],
    "craneboom": ["boom", "arm", "jib", "ausleger"],
    "cranetelescopic": ["telescop", "extension", "teleskop", "auszug"],
}


def crane_part_root(part_name: str) -> str:
    """Virtual aggregation root for a crane part: ``<crane_root>#<part>``
    (generate_construction_data.py:186-187)."""
    return CRANE_ROOT + "#" + part_name


def get_object_root(
    prim_path: str, crane_part_map: Optional[Dict[str, Tuple[str, int]]] = None
) -> Tuple[Optional[str], Optional[str], Optional[int]]:
    """Collapse a mesh prim path to (object_root, class_name, class_id).

    Host-side mirror of the reference's ``get_object_root``
    (generate_construction_data.py:144-233): fence/tree/cone specials, crane
    with map -> child-name -> keyword fallbacks, dumper, human, then the
    generic keyword scan over CONSTRUCTION_CLASS.
    """
    low = prim_path.lower()

    if "fencing_height_" in low:
        parts = prim_path.split("/")
        for i, part in enumerate(parts):
            if "Fencing_height_" in part:
                return "/".join(parts[: i + 1]), "fence", CONSTRUCTION_CLASS["fence"]

    if "/world/tree/tree" in low:
        parts = prim_path.split("/")
        if len(parts) >= 4:
            return "/".join(parts[:4]), "tree", CONSTRUCTION_CLASS["tree"]

    if "/cone001" in low:
        parts = prim_path.split("/")
        for i, part in enumerate(parts):
            if part.lower().startswith("cone001"):
                return "/".join(parts[: i + 1]), "trafficcone", CONSTRUCTION_CLASS["trafficcone"]

    if "pk7501sld" in low or "pk7" in low:
        if crane_part_map and prim_path in crane_part_map:
            part_name, class_id = crane_part_map[prim_path]
            return crane_part_root(part_name), part_name, class_id

        if prim_path.startswith(CRANE_ROOT + "/") or low.startswith(CRANE_ROOT.lower() + "/"):
            first_segment = prim_path[len(CRANE_ROOT) + 1 :].split("/")[0].lower()
            if first_segment in CRANE_PART_CHILD_MAP:
                part_name, class_id = CRANE_PART_CHILD_MAP[first_segment]
                return crane_part_root(part_name), part_name, class_id

        sub = low[low.find("pk7") :]
        for part_name, kws in _CRANE_KEYWORDS.items():
            if any(kw in sub for kw in kws):
                return crane_part_root(part_name), part_name, CONSTRUCTION_CLASS[part_name]
        return CRANE_ROOT, "crane", CONSTRUCTION_CLASS["crane"]

    if "09684481" in low:
        return DUMPER_ROOT, "dumper", CONSTRUCTION_CLASS["dumper"]

    if "dhgen" in low:
        return HUMAN_ROOT, "human", CONSTRUCTION_CLASS["human"]

    for key, class_id in CONSTRUCTION_CLASS.items():
        if key in low:
            return prim_path, key, class_id

    return None, None, None


def build_crane_part_map(children: Dict[str, list]) -> Dict[str, Tuple[str, int]]:
    """Expand a {first_level_child_path: [descendant_paths]} mapping into the
    full prim-path -> (part, class) table, unknown children defaulting to the
    whole crane (reference build_crane_part_map, generate_construction_data.py:
    1234-1279)."""
    out: Dict[str, Tuple[str, int]] = {}
    for child_path, descendants in children.items():
        name = child_path.rsplit("/", 1)[-1].lower()
        part = CRANE_PART_CHILD_MAP.get(name, ("crane", 3))
        out[child_path] = part
        for d in descendants:
            out[d] = part
    return out
