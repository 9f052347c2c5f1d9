"""A toy segmentation model, the reference file of the `toy` configuration
that the benchmark's tests add to a copy of the benchmark as files alone:
a 4x4 patch embedding (a convolution), LayerNorm, one multi-head
self-attention whose two products go through `Numerics.matmul`, its
projections and an f32 classifier through `Numerics.linear`, GELU, and a
bilinear resize of the logits to the input's size.  Its weights mix two
law families: He-normal for the convolution, a truncated normal at std
0.02 for the linear layers."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100_bench.reference.layers import PLAIN
from h100_bench.weights import TRUNC_STD, fan_in, fixed

PATCH = 4


class Toy(nn.Module):
    """f32 channel-major logits [B, num_classes, H, W] of NCHW input."""

    def __init__(self, num_classes, width=16, heads=2,
                 compute_dtype=torch.float32, num=PLAIN):
        super().__init__()
        self.heads, self.compute_dtype, self.num = heads, compute_dtype, num
        self.embed = nn.Conv2d(3, width, PATCH, stride=PATCH)
        self.norm = nn.LayerNorm(width)
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)
        self.head = nn.Linear(width, num_classes)

    def forward(self, x):
        num, dt = self.num, self.compute_dtype
        e = self.embed
        y = num.conv(x.to(dt), e.weight, e.bias, stride=PATCH)
        b, c, h, w = y.shape
        t = y.flatten(2).transpose(1, 2)                       # [B, N, C]
        n = F.layer_norm(t, (c,), self.norm.weight.to(dt),
                         self.norm.bias.to(dt))
        d = c // self.heads
        q, k, v = num.linear(n, self.qkv.weight, self.qkv.bias).view(
            b, h * w, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        att = torch.softmax(num.matmul(q, k.transpose(-1, -2))
                            / math.sqrt(d), dim=-1)
        o = num.matmul(att, v).transpose(1, 2).reshape(b, h * w, c)
        t = F.gelu(t + num.linear(o, self.proj.weight, self.proj.bias))
        logits = num.linear(t.float(), self.head.weight, self.head.bias)
        logits = logits.transpose(1, 2).reshape(b, -1, h, w)
        return F.interpolate(logits, size=x.shape[2:], mode="bilinear",
                             align_corners=True)


MODEL = Toy
# the convolution and the products of the linear layers and attention
DENSE_OPS = ("convolution", "mm")


def weight_law(name: str, shape):
    law = fixed(name)
    if law is not None:
        return law
    if len(shape) == 4:
        return "normal", math.sqrt(2.0 / fan_in(shape))
    if len(shape) == 2:
        return "trunc", 0.02 / TRUNC_STD
    return "const", 1.0  # LayerNorm scale
