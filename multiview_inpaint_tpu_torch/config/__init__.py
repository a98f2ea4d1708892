from .registries import (FRONT_VIEWS, INSERTION_PROMPTS, ORBIT_PARAMS,
                         VIS_PARAMS, OrbitParams, SPIN_NERF_SCENES)
