"""The object roots of the world2.usd scene graph
(generate_construction_data.py:128-141) and the ``#``-separated virtual
crane part roots (186-187), which name each instance's ``prim_path``.
"""

from __future__ import annotations

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

def crane_part_root(part_name: str) -> str:
    """Virtual aggregation root for a crane part: ``<crane_root>#<part>``
    (generate_construction_data.py:186-187)."""
    return CRANE_ROOT + "#" + part_name


