"""Scene/case registries: the pipeline's per-scene database.

The reference hard-codes these in ``gs-simp/scene/helpers.py:9-94`` and
``metrics/helpers.py:1-30``; here they live in one typed module (loadable /
overridable from JSON via :func:`load_registry_overrides`) so users can add
scenes without editing library code.

- ``FRONT_VIEWS``: the reference frame (image name) per scene that anchors
  the orbital camera sequence.
- ``INSERTION_PROMPTS``: text prompt per ``<scene>_<case>``.
- ``ORBIT_PARAMS`` / ``VIS_PARAMS``: per-scene orbit geometry
  (k_lift, r_scale, k_bias, view_range).
- ``SPIN_NERF_SCENES``: scenes that auto-switch to resolution divisor 4.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict

PI = math.pi


@dataclasses.dataclass(frozen=True)
class OrbitParams:
    k_lift: float = 0.0
    r_scale: float = 1.0
    k_bias: float = 0.0
    view_range: float = PI / 3.0


SPIN_NERF_SCENES = ("1", "2", "3", "3b", "4", "7", "9", "10", "12",
                    "book", "trash")

FRONT_VIEWS: Dict[str, str] = {
    # Mip-NeRF-360
    "bicycle": "_DSC8756", "garden": "DSC07956", "bonsai": "DSCF5565",
    "kitchen": "DSCF0657", "stump": "_DSC9214", "room": "DSCF4680",
    "counter": "DSCF5898",
    # SpinNeRF
    "1": "20220819_104243", "2": "20220819_104648", "3": "20220819_105148",
    "4": "20220819_105637", "7": "20220819_111557", "9": "20220819_112827",
    "10": "20220823_095100", "12": "20220823_093735(0)",
    "book": "20220811_112812", "trash": "20220811_093603",
}

INSERTION_PROMPTS: Dict[str, str] = {
    "bicycle_bear": "a toy bear sitting on the bench",
    "bicycle_dog": "a toy dog sitting on the bench",
    "kitchen_cup": "a paper cup on the table",
    "stump_flower": "a yellow flower",
    "garden_cake": "a birthday cake on the table",
    "garden_gnome": "a garden gnome on the table",
    "counter_bread": "a bread on the table",
    "counter_grinder": "a pepper grinder on the table",
    "2_suitcase": "a suitcase on the floor",
    "9_trash bin": "a trash bin on the floor",
    "10_candlestick": "a candlestick on the bench",
    "trash_school bag": "a school bag on the floor",
}

# Scene descriptions for directional CLIP similarity (metrics/helpers.py).
SCENE_DESCRIPTIONS: Dict[str, str] = {
    "bicycle": "a bench in the yard",
    "kitchen": "a table in the kitchen",
    "stump": "a stump in the yard",
    "garden": "a table in the garden",
    "counter": "a kitchen counter",
    "2": "a floor in the office building",
    "9": "a floor in the office building",
    "10": "a bench near the wall",
    "trash": "a floor near the wall",
}

ORBIT_PARAMS: Dict[str, OrbitParams] = {
    "bicycle": OrbitParams(PI / 6, 0.7, 0.0, PI / 3),
    "bonsai": OrbitParams(PI / 6, 0.6, 0.0, PI / 3),
    "kitchen": OrbitParams(PI / 4, 0.8, 0.0, PI / 3),
    "garden": OrbitParams(PI / 6, 0.7, 0.0, PI / 3),
    "stump": OrbitParams(PI / 6, 0.5, 0.0, PI / 3),
    "counter": OrbitParams(PI / 3, 0.7, 0.0, PI / 3),
    "1": OrbitParams(PI * 5 / 12, 0.7, 0.0, PI / 3),
    "2": OrbitParams(PI * 5 / 12, 0.7, 0.0, PI / 24),
    "3": OrbitParams(PI / 6, 1.0, 0.0, PI / 3),
    "4": OrbitParams(PI / 6, 1.0, 0.0, PI / 3),
    "7": OrbitParams(-PI * 11 / 6, 1.2, 0.0, PI / 12),
    "9": OrbitParams(PI * 5 / 12, 0.75, 0.0, PI / 24),
    "10": OrbitParams(PI / 9, 0.85, PI / 12, PI / 4),
    "12": OrbitParams(PI / 3, 0.85, 0.0, PI / 3),
    "book": OrbitParams(PI / 3, 0.85, 0.0, PI / 12),
    "trash": OrbitParams(PI / 3, 0.8, PI / 12, PI / 4),
}

VIS_PARAMS: Dict[str, OrbitParams] = {
    "bicycle": OrbitParams(PI / 6, 0.7, 0.0, PI / 3),
    "kitchen": OrbitParams(PI / 4, 0.8, 0.0, PI / 3),
    "garden": OrbitParams(PI / 6, 0.75, 0.0, PI / 3),
    "stump": OrbitParams(PI / 12, 0.6, 0.0, PI / 3),
    "counter": OrbitParams(PI / 3, 0.7, 0.0, PI / 3),
    "2": OrbitParams(PI * 5 / 12, 0.7, 0.0, PI / 18),
    "9": OrbitParams(PI * 5 / 12, 0.75, 0.0, PI / 18),
    "10": OrbitParams(PI / 9, 0.7, PI / 12, PI / 18),
    "book": OrbitParams(PI / 3, 0.85, 0.0, PI / 12),
    "trash": OrbitParams(PI / 3, 0.7, PI / 12, PI / 18),
}


def get_orbit_params(scene_key: str, table: Dict[str, OrbitParams]
                     | None = None, allow_default: bool = False,
                     ) -> OrbitParams:
    """Resolve a scene's orbit geometry.

    The reference indexes its hard-coded dict directly and raises
    ``KeyError`` on unknown scenes (``gs-simp/scene/helpers.py:9-94``);
    a silent default here produced plausible-looking but wrong orbits
    for typo'd scene ids. Unknown keys now raise with a hint unless
    ``allow_default`` is set, which warns loudly and returns defaults.
    """
    table = ORBIT_PARAMS if table is None else table
    if scene_key in table:
        return table[scene_key]
    msg = (f"scene {scene_key!r} is not in the orbit registry "
           f"(known: {sorted(table)})")
    if allow_default:
        import warnings
        warnings.warn(msg + " — using default OrbitParams", stacklevel=2)
        return OrbitParams()
    raise KeyError(msg + "; add it via --registry JSON or pass "
                   "--allow_default_orbit")


def load_registry_overrides(path: str) -> None:
    """Merge user registries from a JSON file:
    ``{"front_views": {...}, "insertion_prompts": {...},
       "orbit_params": {"scene": {"k_lift": ..}, ...}}``.
    """
    with open(path) as f:
        data = json.load(f)
    FRONT_VIEWS.update(data.get("front_views", {}))
    INSERTION_PROMPTS.update(data.get("insertion_prompts", {}))
    for name, kw in data.get("orbit_params", {}).items():
        ORBIT_PARAMS[name] = OrbitParams(**kw)
    for name, kw in data.get("vis_params", {}).items():
        VIS_PARAMS[name] = OrbitParams(**kw)
