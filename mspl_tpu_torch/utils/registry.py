"""Constants and dataset infos (port of mspl_tpu/utils/registry.py).

Only what the pseudo-label path needs: the ignore label, the ImageNet
normalization statistics, and the infos of the three source datasets and
the greenhouse target.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

IGNORE_LABEL = 255

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class DatasetInfo:
    name: str
    num_classes: int
    # canonical (width, height) the reference trains/evaluates at
    size_wh: Tuple[int, int]
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    class_names: Tuple[str, ...] = field(default=())


DATASET_INFO: Dict[str, DatasetInfo] = {
    "camvid": DatasetInfo(
        name="camvid",
        num_classes=11,
        size_wh=(480, 360),
        class_names=(
            "sky", "building", "pole", "road", "sidewalk", "tree",
            "sign", "fence", "car", "pedestrian", "bicyclist",
        ),
    ),
    "cityscapes": DatasetInfo(
        name="cityscapes",
        num_classes=19,
        size_wh=(1024, 512),
        class_names=(
            "road", "sidewalk", "building", "wall", "fence", "pole",
            "traffic_light", "traffic_sign", "vegetation", "terrain", "sky",
            "person", "rider", "car", "truck", "bus", "train",
            "motorcycle", "bicycle",
        ),
    ),
    "forest": DatasetInfo(
        name="forest",
        num_classes=5,
        size_wh=(480, 360),
        class_names=("road", "grass", "vegetation", "sky", "obstacle"),
    ),
    "greenhouse": DatasetInfo(
        name="greenhouse",
        num_classes=3,
        size_wh=(480, 256),
        class_names=("plant", "artificial_object", "ground"),
    ),
}

def dataset_info(name: str) -> DatasetInfo:
    try:
        return DATASET_INFO[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset '{name}'; supported: {sorted(DATASET_INFO)}"
        ) from None
