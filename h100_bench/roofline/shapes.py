"""The call shapes of the port's decoder and fusion kernels in one batch
of an ensemble, worked out from the configuration: an ESPNetv2's decoder
blocks sit at 1/16, 1/8, 1/4 and 1/2 of the image, each at the projection
width min(dec_base_planes, max(classes // 2, 8)) of its model."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

SCALES = (2.0, 1.5, 1.0, 0.5, 0.1)


def model_key(spec: Dict) -> Tuple:
    """A configuration's `model` entry as a hashable tuple of its items,
    sorted by key, lists as tuples."""
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in spec.items()))


@dataclass(frozen=True)
class Model:
    """One model of a batch: its classes, the bytes of its activations and
    logits, and its configuration's whole `model` entry (`model_key`), from
    which a roofline file reads the widths it needs."""
    classes: int
    itemsize: int
    model: Tuple

    @property
    def spec(self) -> Dict:
        return dict(self.model)

    @property
    def espnetv2(self) -> bool:
        return self.spec["name"] == "espnetv2"

    @property
    def dec_base_planes(self) -> int:
        return self.spec.get("dec_base_planes", 16)


def proj_width(m: Model) -> int:
    return min(m.dec_base_planes, max(m.classes // 2, 8))


def planes(hw: Tuple[int, int]):
    """The decoder planes (h, w) at strides 16, 8, 4, 2."""
    out = []
    h, w = hw
    for _ in range(4):
        h, w = -(-h // 2), -(-w // 2)
        out.append((h, w))
    return out[::-1]


def branch_sizes(h: int, w: int, scales: Sequence[float] = SCALES):
    return tuple((max(int(math.ceil(h * s)), 5), max(int(math.ceil(w * s)), 5))
                 for s in scales)
