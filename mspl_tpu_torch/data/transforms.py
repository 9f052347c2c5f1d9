"""Device-side image normalization (port of
mspl_tpu/data/transforms.py::normalize).

The train-side random transforms belong to the training slice of the port.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from mspl_tpu_torch.utils.registry import IMAGENET_MEAN, IMAGENET_STD


def normalize(
    img: torch.Tensor,
    mean: Tuple[float, float, float] = IMAGENET_MEAN,
    std: Tuple[float, float, float] = IMAGENET_STD,
) -> torch.Tensor:
    """uint8/float [B,H,W,C] image in [0,255] -> normalized float32
    [B,C,H,W], on the tensor's own device.

    The arithmetic runs in NHWC exactly as the JAX version does, then the
    batch is permuted to NCHW once.  Channels beyond len(mean) (the RGB-D
    depth channel) are normalized with mean 0.5 / std 0.5."""
    x = img.to(torch.float32) / 255.0
    c = x.shape[-1]
    mean_t = _stats(tuple(mean) + (0.5,) * max(0, c - len(mean)), x.device)
    std_t = _stats(tuple(std) + (0.5,) * max(0, c - len(std)), x.device)
    x = (x - mean_t) / std_t
    return x.permute(0, 3, 1, 2).contiguous()


@lru_cache(maxsize=None)
def _stats(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    # made once per device: a host-to-device copy from pageable memory
    # waits for the stream, which would stall every batch
    return torch.tensor(values, dtype=torch.float32, device=device)
