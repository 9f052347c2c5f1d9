"""Seeded model weights, made on the device in one draw a model.

The laws are the port's initializers' (flax's families): ESPNetv2 convs
He-normal (std sqrt(2 / fan_in)), PReLU alphas 0.25; DeepLab convs a
truncated normal (cut at 2 std) at variance 2 / fan_in, its classifier at
1 / fan_in; BatchNorm at identity (scale 1, bias 0, mean 0, variance 1),
other biases 0.  The state dict's keys and shapes come from the
benchmark's own reference model, so the same dict loads into the port's
model and into the reference; the same seed gives the same bits.

A model that runs in eval mode takes its BatchNorms' running statistics
from images first (`calibrated`), as a trained model's describe the images
it sees: at identity a random network's logits reach the thousands and
every softmax is one-hot.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_TRUNC = 2.0
_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2


def _fan_in(shape) -> int:
    return int(math.prod(shape[1:]))


def _laws(kind: str, name: str, shape):
    """(law, value): law 'normal' or 'trunc' with value the std scale, or
    'const' with value the fill."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return "const", 1.0
    if leaf in ("running_mean", "num_batches_tracked", "bias"):
        return "const", 0.0
    if kind == "espnetv2":
        if name.endswith("dw_weights"):
            return "normal", math.sqrt(2.0 / 9.0)
        if len(shape) == 4:
            return "normal", math.sqrt(2.0 / _fan_in(shape))
        if leaf == "alpha":
            return "const", 0.25
        return "const", 1.0  # BatchNorm scale
    if kind == "deeplabv3":
        if len(shape) == 4:
            scale = 1.0 if name.startswith("classifier.") else 2.0
            return "trunc", math.sqrt(scale / _fan_in(shape)) / _TRUNC_STD
        return "const", 1.0
    raise ValueError(f"no weight laws for '{kind}'")


def make_state(kind: str, shapes: Dict[str, torch.Size], seed: int,
               device) -> Dict[str, torch.Tensor]:
    """A state dict of `shapes` (name -> shape, in the model's order) with
    the laws of `kind`, drawn from `seed` on `device`."""
    draws = [(k, s) for k, s in shapes.items()
             if _laws(kind, k, s)[0] != "const"]
    total = sum(math.prod(s) for _, s in draws)
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "deeplabv3":
        lo = math.erf(-_TRUNC / math.sqrt(2))
        hi = math.erf(_TRUNC / math.sqrt(2))
        u = torch.rand(total, generator=g, device=device) * (hi - lo) + lo
        flat = (torch.erfinv(u) * math.sqrt(2)).clamp_(-_TRUNC, _TRUNC)
    else:
        flat = torch.randn(total, generator=g, device=device)
    state, off = {}, 0
    for name, shape in shapes.items():
        law, value = _laws(kind, name, shape)
        if law == "const":
            dtype = torch.int64 if name.endswith("num_batches_tracked") \
                else torch.float32
            state[name] = torch.full(tuple(shape), value, dtype=dtype,
                                     device=device)
            continue
        n = math.prod(shape)
        state[name] = flat[off:off + n].view(tuple(shape)).mul_(value)
        off += n
    return state


def shapes_of(model: torch.nn.Module) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in model.state_dict().items()}


def calibrated(model: torch.nn.Module,
               x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """`model`'s state with every BatchNorm's running statistics set to the
    mean and biased variance, a channel, of what reaches it in one
    train-mode forward over `x` (each normalizes by those same statistics
    there, so every layer's reach the next as eval mode then sees them)."""
    stats = {}

    def take(mod, args):
        var, mean = torch.var_mean(args[0].float(), dim=(0, 2, 3),
                                   unbiased=False)
        stats[mod] = (mean, var)

    hooks = [m.register_forward_pre_hook(take) for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    model.train()
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    for m, (mean, var) in stats.items():
        m.running_mean.copy_(mean)
        m.running_var.copy_(var)
    return model.eval().state_dict()
