"""Seeded model weights, made on the device in one draw a law family.

Each reference model's file (`reference/models/<name>.py`) gives the law of
every leaf of its state dict as `weight_law(name, shape) -> (law, value)`:
`normal` (a unit normal times `value`), `trunc` (a unit normal cut at 2
std, times `value`) or `const` (filled with `value`).  The laws are the
port's initializers' (flax's families).  The state dict's keys and shapes
come from the benchmark's own reference model, so the same dict loads
into the port's model and into the reference; the same seed gives the
same bits.

A model that runs in eval mode takes its BatchNorms' running statistics
from images first (`calibrated`), as a trained model's describe the images
it sees: at identity a random network's logits reach the thousands and
every softmax is one-hot.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

TRUNC = 2.0
TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2


def fan_in(shape) -> int:
    return int(math.prod(shape[1:]))


def fixed(name: str) -> Optional[Tuple[str, float]]:
    """The law every model here gives BatchNorm's running statistics
    (mean 0, variance 1), its step count and biases (0); None for other
    leaves."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return "const", 1.0
    if leaf in ("running_mean", "num_batches_tracked", "bias"):
        return "const", 0.0
    return None


def _normal(n: int, g: torch.Generator, device) -> torch.Tensor:
    return torch.randn(n, generator=g, device=device)


def _trunc(n: int, g: torch.Generator, device) -> torch.Tensor:
    lo = math.erf(-TRUNC / math.sqrt(2))
    hi = math.erf(TRUNC / math.sqrt(2))
    u = torch.rand(n, generator=g, device=device) * (hi - lo) + lo
    return (torch.erfinv(u) * math.sqrt(2)).clamp_(-TRUNC, TRUNC)


# each law family's unit draw of n values
DRAWS = {"normal": _normal, "trunc": _trunc}


def make_state(kind: str, shapes: Dict[str, torch.Size], seed: int,
               device) -> Dict[str, torch.Tensor]:
    """A state dict of `shapes` (name -> shape, in the model's order) with
    the laws of the reference model `kind`, drawn from `seed` on `device`:
    one flat draw a law family, the families in the order of their first
    leaf, each leaf taking the next values of its family's draw."""
    from h100_bench.reference.pipeline import model_module

    law_of = model_module(kind).weight_law
    laws = {k: law_of(k, s) for k, s in shapes.items()}
    totals: Dict[str, int] = {}
    for k, (law, _) in laws.items():
        if law != "const":
            totals[law] = totals.get(law, 0) + math.prod(shapes[k])
    g = torch.Generator(device=device).manual_seed(seed)
    flats = {law: DRAWS[law](n, g, device) for law, n in totals.items()}
    offsets = dict.fromkeys(totals, 0)
    state = {}
    for name, shape in shapes.items():
        law, value = laws[name]
        if law == "const":
            dtype = torch.int64 if name.endswith("num_batches_tracked") \
                else torch.float32
            state[name] = torch.full(tuple(shape), value, dtype=dtype,
                                     device=device)
            continue
        n, off = math.prod(shape), offsets[law]
        state[name] = flats[law][off:off + n].view(tuple(shape)).mul_(value)
        offsets[law] = off + n
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
