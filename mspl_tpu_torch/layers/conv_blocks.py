"""Convolution building blocks (port of mspl_tpu/layers/conv_blocks.py):
`C`, `CDilated`, `CB`, `CBR`, `BR` and per-channel `PReLU`, on NCHW.

BatchNorm (eps 1e-5) normalizes with its running statistics in eval and
with the batch's in train, where it also updates the running ones as flax
does.  Parameters stay f32; a bf16 activation runs its conv in bf16 with
the weights cast to bf16 (as flax's `dtype=x.dtype`), and BatchNorm
computes in f32 and rounds once, as flax's does.  BatchNorm is not folded
into the conv before it: on the H100 the conv's bias then runs as a
separate broadcast add that costs more than the BatchNorm pass
(chip_smoke.py --profile, PERF.md).  Grouped and depthwise convolutions
are native `groups=`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's convention: running = 0.9 * running + 0.1 * batch


class PReLU(nn.Module):
    """Per-channel PReLU: y = max(x, 0) + alpha_c * min(x, 0); alpha 0.25."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.alpha.to(x.dtype))


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5): (x - mean) * scale / sqrt(var + eps) + bias,
    computed in f32 and rounded once to x's dtype (a bf16 activation keeps
    f32 statistics, as flax's BatchNorm does).

    Eval takes the running statistics.  Train takes the batch's mean and
    biased variance over (B, H, W) and updates the running statistics as
    flax does: running = 0.9 * running + 0.1 * batch, with the *biased*
    variance.  torch's own update (`F.batch_norm(training=True)` with
    buffers) would take the unbiased one, so the buffers are updated here,
    under no_grad, and torch normalizes without them.

    With one value per channel (B*H*W == 1, as a DeepLab ASPP image pool
    at batch 1) torch's batch norm raises; flax normalizes all the same:
    x - mean is 0, so the output is the bias, the running mean takes the
    value and the running variance 0.  That case is normalized here by
    hand, with the gradients flax's gives (0 to x and the scale)."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS)

    def eval_affine(self):
        """(scale, shift) of the eval transform, f32 [C] each, folded as the
        JAX package folds it for its fused kernels."""
        a = self.weight / torch.sqrt(self.running_var + self.eps)
        return a, self.bias - self.running_mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        xf = x.to(torch.float32)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean,
                                                     alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var,
                                                    alpha=1 - BN_MOMENTUM)
        if xf.numel() == xf.shape[1]:
            shape = (1, -1, 1, 1)
            a = (self.weight * torch.rsqrt(var + self.eps)).view(shape)
            return ((xf - xf.mean(dim=(0, 2, 3), keepdim=True)) * a
                    + self.bias.view(shape)).to(x.dtype)
        return F.batch_norm(xf, None, None, self.weight, self.bias, True,
                            0.0, self.eps).to(x.dtype)


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
