"""Model factory and initializers (port of mspl_tpu/models/factory.py).

`build_segmentation_model` builds a segmentation model by registry name, as
a CPU module (move it with `.to(device)` or pass it to an entry point).
`init_model` draws its weights in place from a torch.Generator with flax's
initializers for that model: the JAX package's distributions, not its bits
(one draws from a PRNG key, the other from a torch generator).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from mspl_tpu_torch.layers.conv_blocks import BatchNorm
from mspl_tpu_torch.models.deeplab import DeepLabV3, _Conv
from mspl_tpu_torch.models.espnetv2 import (EESPNet, ESPNetv2Segmentation,
                                            init_random)
from mspl_tpu_torch.utils.registry import MODEL_NAMES

# flax's truncated-normal variance scaling draws from a unit normal cut at
# +-2 and divides by that law's std, so the kept variance is the scale's
_TRUNC = 2.0
_TRUNC_STD = 0.87962566103423978


def build_segmentation_model(name: str, num_classes: int, s: float = 2.0,
                             compute_dtype: torch.dtype = torch.float32,
                             **kwargs) -> nn.Module:
    """'espnetv2' (width scaler `s`) or 'deeplabv3'; `kwargs` go to the
    model's constructor."""
    if name == "espnetv2":
        return ESPNetv2Segmentation(num_classes, s=s,
                                    compute_dtype=compute_dtype, **kwargs)
    if name == "deeplabv3":
        return DeepLabV3(num_classes, compute_dtype=compute_dtype, **kwargs)
    raise ValueError(f"unknown model '{name}'; supported: {MODEL_NAMES}")


def _variance_scaling(w: torch.Tensor, scale: float,
                      generator: Optional[torch.Generator]) -> None:
    """flax's `variance_scaling(scale, "fan_in", "truncated_normal")` on an
    OIHW kernel (fan_in = I * H * W) or a Linear weight [out, in]."""
    fan_in = w[0].numel()
    lo, hi = math.erf(-_TRUNC / math.sqrt(2)), math.erf(_TRUNC / math.sqrt(2))
    u = torch.rand(w.shape, generator=generator) * (hi - lo) + lo
    z = (torch.erfinv(u) * math.sqrt(2)).clamp(-_TRUNC, _TRUNC)
    w.copy_(z * (math.sqrt(scale / fan_in) / _TRUNC_STD))


def _init_deeplab(model: DeepLabV3,
                  generator: Optional[torch.Generator]) -> None:
    """He-normal for the convs, lecun-normal and a zero bias for the
    classifier, BatchNorm at identity (scale 1, bias 0, mean 0, var 1)."""
    for mod in model.modules():
        if isinstance(mod, _Conv):
            _variance_scaling(mod.weight, 2.0, generator)
        elif isinstance(mod, BatchNorm):
            mod.reset_parameters()
    _variance_scaling(model.classifier.weight, 1.0, generator)
    model.classifier.bias.zero_()


def init_model(model: nn.Module,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initialize `model`'s weights in place, drawn on the CPU from
    `generator` so that a seed gives the same weights on every device, and
    return it."""
    with torch.no_grad():
        if isinstance(model, DeepLabV3):
            _init_deeplab(model, generator)
        elif isinstance(model, ESPNetv2Segmentation):
            init_random(model, generator)
        elif isinstance(model, EESPNet):
            # the classifier is flax's Dense: lecun-normal, zero bias
            init_random(model, generator)
            if model.num_classes is not None:
                _variance_scaling(model.classifier.weight, 1.0, generator)
        else:
            raise TypeError(f"no initializer for {type(model).__name__}")
    return model
