"""Label-space converters: source class ids -> greenhouse target ids (port
of mspl_tpu/data/label_space.py).

Greenhouse target space: 0 = plant, 1 = artificial_object, 2 = ground,
255 = ignore.  `label_conversion_matrix(src)` is the float32
[num_src, num_target + 1] 0/1 pooling table that sums the probability mass
of the source classes mapped to each target class; its last column collects
the mass mapped to ignore.  The fused pseudo-label kernel consumes it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np

GREENHOUSE_IGNORE = 255
GREENHOUSE_NUM_CLASSES = 3  # plant, artificial_object, ground

_PLANT, _ARTIFICIAL, _GROUND, _IGN = 0, 1, 2, GREENHOUSE_IGNORE

# CamVid 11-class order:
# sky, building, pole, road, sidewalk, tree, sign, fence, car, pedestrian,
# bicyclist
CAMVID_TO_GREENHOUSE: Tuple[int, ...] = (
    _IGN, _ARTIFICIAL, _ARTIFICIAL, _GROUND, _GROUND, _PLANT,
    _ARTIFICIAL, _ARTIFICIAL, _ARTIFICIAL, _IGN, _IGN,
)

# Cityscapes 19 train-id order: road, sidewalk, building, wall, fence, pole,
# traffic light, traffic sign, vegetation, terrain, sky, person, rider, car,
# truck, bus, train, motorcycle, bicycle
CITYSCAPES_TO_GREENHOUSE: Tuple[int, ...] = (
    _GROUND, _GROUND, _ARTIFICIAL, _ARTIFICIAL, _ARTIFICIAL, _ARTIFICIAL,
    _ARTIFICIAL, _ARTIFICIAL, _PLANT, _GROUND, _IGN, _IGN, _IGN,
    _ARTIFICIAL, _ARTIFICIAL, _ARTIFICIAL, _ARTIFICIAL, _ARTIFICIAL,
    _ARTIFICIAL,
)

# Freiburg Forest 5-class order: road, grass, vegetation, sky, obstacle
FOREST_TO_GREENHOUSE: Tuple[int, ...] = (
    _GROUND, _GROUND, _PLANT, _IGN, _ARTIFICIAL,
)

# identity map for the target model joining later self-training rounds
GREENHOUSE_IDENTITY: Tuple[int, ...] = (_PLANT, _ARTIFICIAL, _GROUND)

_LUTS: Dict[str, Tuple[int, ...]] = {
    "camvid": CAMVID_TO_GREENHOUSE,
    "cityscapes": CITYSCAPES_TO_GREENHOUSE,
    "forest": FOREST_TO_GREENHOUSE,
    "greenhouse": GREENHOUSE_IDENTITY,
}


def label_conversion_lut(src: str,
                         num_target: int = GREENHOUSE_NUM_CLASSES) -> np.ndarray:
    """int32 LUT [num_src] mapping source class id -> target id (255 ignore)."""
    if src not in _LUTS:
        raise ValueError(
            f"no label conversion from '{src}'; have {sorted(_LUTS)}")
    lut = np.asarray(_LUTS[src], np.int32)
    if not ((lut == GREENHOUSE_IGNORE) | (lut < num_target)).all():
        raise ValueError(f"LUT for {src} exceeds target space {num_target}")
    return lut


@lru_cache(maxsize=None)
def _conversion_matrix_cached(src: str, num_target: int) -> np.ndarray:
    lut = label_conversion_lut(src, num_target)
    mat = np.zeros((lut.shape[0], num_target + 1), np.float32)
    for s, t in enumerate(lut):
        mat[s, num_target if t == GREENHOUSE_IGNORE else t] = 1.0
    return mat


def label_conversion_matrix(src: str,
                            num_target: int = GREENHOUSE_NUM_CLASSES
                            ) -> np.ndarray:
    """float32 [num_src, num_target+1] probability-pooling matrix; the last
    column accumulates mass that maps to ignore."""
    return _conversion_matrix_cached(src, num_target)
