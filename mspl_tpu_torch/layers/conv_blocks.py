"""Convolution building blocks (port of mspl_tpu/layers/conv_blocks.py):
`C`, `CDilated`, `CB`, `CBR`, `BR` and per-channel `PReLU`, on NCHW.

Eval mode only in this slice: BatchNorm normalizes with its running
statistics (eps 1e-5) and a train-mode forward raises.  Parameters stay
f32; a bf16 activation runs its conv in bf16 with the weights cast to bf16
(as flax's `dtype=x.dtype`), and BatchNorm computes in f32 and rounds once,
as flax's does.  BatchNorm is not folded into the conv before it: on the
H100 the conv's bias then runs as a separate broadcast add that costs more
than the BatchNorm pass (chip_smoke.py --profile, PERF.md).  Grouped and
depthwise convolutions are native `groups=`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
TRAIN_SLICE = ("a train-mode forward belongs to the training slice of the "
               "PyTorch port (train step and self-training round); this "
               "slice runs eval only")


class PReLU(nn.Module):
    """Per-channel PReLU: y = max(x, 0) + alpha_c * min(x, 0); alpha 0.25."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.alpha.to(x.dtype))


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5) in eval: (x - mean) * scale / sqrt(var + eps)
    + bias, computed in f32 and rounded once to x's dtype (one pass; a bf16
    activation keeps f32 statistics, as flax's BatchNorm does)."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS)

    def eval_affine(self):
        """(scale, shift) of the eval transform, f32 [C] each, folded as the
        JAX package folds it for its fused kernels."""
        a = self.weight / torch.sqrt(self.running_var + self.eps)
        return a, self.bias - self.running_mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(TRAIN_SLICE)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class C(nn.Module):
    """Plain conv, padding dilation*(k-1)//2, no BN/activation (reference
    `C`); with groups == channels it is the depthwise conv."""

    def __init__(self, nin: int, nout: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(nin, nout, kernel_size, stride=stride,
                              padding=dilation * (kernel_size - 1) // 2,
                              dilation=dilation, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        bias = None if c.bias is None else c.bias.to(x.dtype)
        return F.conv2d(x, c.weight.to(x.dtype), bias, c.stride, c.padding,
                        c.dilation, c.groups)


class CDilated(C):
    """Dilated conv (reference `CDilated`)."""


class CB(nn.Module):
    """Conv + BatchNorm (reference `CB`)."""

    def __init__(self, nin: int, nout: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.conv = C(nin, nout, kernel_size, stride, dilation, groups)
        self.bn = BatchNorm(nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class CBR(nn.Module):
    """Conv + BatchNorm + PReLU (reference `CBR`)."""

    def __init__(self, nin: int, nout: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.cb = CB(nin, nout, kernel_size, stride, dilation, groups)
        self.act = PReLU(nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.cb(x))


class BR(nn.Module):
    """BatchNorm + PReLU (reference `BR`)."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = BatchNorm(features)
        self.act = PReLU(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(x))
