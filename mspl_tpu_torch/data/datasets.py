"""Procedural segmentation scenes (a copy of
mspl_tpu/data/datasets.py::SyntheticSegmentation).

Deterministic scenes of colored rectangles on a background, labels
following the rectangles exactly, so every stage of a self-training round
runs with no data set on disk.  The file-list data sets (CamVid,
Cityscapes, Forest, Greenhouse) belong to a later slice of the port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from mspl_tpu_torch.utils.registry import IGNORE_LABEL, DatasetInfo


class SyntheticSegmentation:
    """Deterministic procedural scenes for tests/benchmarks: colored
    rectangles + background; labels follow the rectangle layout exactly,
    so a reasonable model can fit them and mIoU can approach 1."""

    def __init__(
        self,
        num_classes: int = 4,
        size_wh: Tuple[int, int] = (64, 48),
        length: int = 32,
        seed: int = 0,
        unlabeled: bool = False,
    ):
        self.info = DatasetInfo(name="synthetic", num_classes=num_classes,
                                size_wh=size_wh)
        self.size_wh = size_wh
        self.length = length
        self.seed = seed
        self.unlabeled = unlabeled
        self.num_classes = num_classes
        # distinct mean color per class so the task is learnable
        rng = np.random.default_rng(12345)
        self.palette = rng.integers(40, 215, size=(num_classes, 3)).astype(
            np.uint8)

    def __len__(self) -> int:
        return self.length

    @property
    def shape_hw(self) -> Tuple[int, int]:
        return (self.size_wh[1], self.size_wh[0])

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        h, w = self.shape_hw
        rng = np.random.default_rng(self.seed * 100003 + i)
        label = np.zeros((h, w), np.uint8)
        img = np.zeros((h, w, 3), np.float32)
        img += self.palette[0]
        for _ in range(4):
            c = int(rng.integers(1, self.num_classes))
            y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
            y1 = int(rng.integers(y0 + h // 8, h))
            x1 = int(rng.integers(x0 + w // 8, w))
            label[y0:y1, x0:x1] = c
            img[y0:y1, x0:x1] = self.palette[c]
        img += rng.normal(0, 8, size=img.shape)
        img = np.clip(img, 0, 255).astype(np.uint8)
        if self.unlabeled:
            label = np.full((h, w), IGNORE_LABEL, np.uint8)
        return img, label
