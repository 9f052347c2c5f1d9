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

Three context managers steer every train-mode BatchNorm entered under
them, so the model's modules take no argument for it (the JAX package's
`bn_stat_groups` is one too, mspl_tpu/layers/bn.py):
`bn_stat_groups(G)` computes the batch statistics per contiguous group of
B / G samples (ghost-batch, per-replica BatchNorm), `frozen_bn_stats()`
leaves the running statistics as they are, for the forward that
activation checkpointing recomputes in the backward (`engine/train.py`),
and `bn_sync(group, D)` says that the batch is this rank's slice of a
global batch split over the D ranks of `group` (a mesh's data axis,
`parallel/mesh.py`): the statistics are then the global batch's, as the
JAX package's are under a mesh.  All three are context variables, so they
hold in the thread that enters them.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's convention: running = 0.9 * running + 0.1 * batch

_BN_GROUPS = contextvars.ContextVar("mspl_bn_stat_groups", default=1)
_BN_UPDATE = contextvars.ContextVar("mspl_bn_update_stats", default=True)
_BN_SYNC = contextvars.ContextVar("mspl_bn_sync", default=None)


@contextlib.contextmanager
def bn_stat_groups(groups: int):
    """Train-mode BatchNorm entered under this context normalizes each
    contiguous group of B / `groups` samples with the group's own
    statistics (`groups` <= 1: the whole batch, the default)."""
    token = _BN_GROUPS.set(max(1, int(groups)))
    try:
        yield
    finally:
        _BN_GROUPS.reset(token)


@contextlib.contextmanager
def frozen_bn_stats():
    """Train-mode BatchNorm entered under this context normalizes with the
    batch statistics as always but leaves the running ones untouched."""
    token = _BN_UPDATE.set(False)
    try:
        yield
    finally:
        _BN_UPDATE.reset(token)


@contextlib.contextmanager
def bn_sync(group, size: int):
    """Train-mode BatchNorm entered under this context takes its batch as
    this rank's contiguous slice of a global batch split over the `size`
    ranks of the process group `group`, in rank order (`size` <= 1: no
    effect)."""
    token = _BN_SYNC.set((group, int(size)) if size > 1 else None)
    try:
        yield
    finally:
        _BN_SYNC.reset(token)


class _GlobalStats(torch.autograd.Function):
    """Per-channel mean and biased variance of x [B, C, H, W] over the
    global batch whose slices the ranks of `group` hold.

    Each rank takes its two-pass statistics (count, mean, M2) as the
    single-device path does, and one `all_reduce` of a zero-padded [D, 3,
    C] f64 buffer brings every rank's; they combine exactly (Chan et al.)
    into the global mean and M2 / N, the variance flax computes.  The
    backward sums the statistics' gradients over the group, since every
    rank's loss depends on them, and hands each rank its rows' share: dx
    = (g_mean + 2 (x - mean) g_var) / N."""

    @staticmethod
    def forward(ctx, x, group, size):
        c = x.shape[1]
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        n = x.numel() // c
        parts = torch.zeros((size, 3, c), dtype=torch.float64,
                            device=x.device)
        me = dist.get_rank(group)
        parts[me, 0] = n
        parts[me, 1] = mean
        parts[me, 2] = var.double() * n
        dist.all_reduce(parts, group=group)
        cnt, means = parts[:, 0], parts[:, 1]
        total = cnt.sum(0)
        gmean = (cnt * means).sum(0) / total
        gvar = (parts[:, 2] + cnt * (means - gmean) ** 2).sum(0) / total
        gmean, gvar = gmean.to(x.dtype), gvar.to(x.dtype)
        ctx.save_for_backward(x, gmean)
        ctx.group, ctx.total = group, float(total[0])
        return gmean, gvar

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean = ctx.saved_tensors
        g = torch.stack([g_mean, g_var]).contiguous()
        dist.all_reduce(g, group=ctx.group)
        shape = (1, -1, 1, 1)
        dx = (g[0].view(shape) + 2.0 * (x - mean.view(shape))
              * g[1].view(shape)) / ctx.total
        return dx, None, None


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
    f32 statistics, as flax's BatchNorm does; an f64 one computes in f64).

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
    hand, with the gradients flax's gives (0 to x and the scale).

    Under `bn_stat_groups(G)`, G > 1, train splits the batch into G
    contiguous groups, normalizes each with its own f32 mean and biased
    variance, and moves the running statistics toward the mean over the
    groups of the group statistics, as the JAX package's ghost-batch
    BatchNorm does; a batch that G does not divide raises ValueError.

    Under `bn_sync(group, D)`, D > 1, train takes the mean and biased
    variance of the global batch (`_GlobalStats`: one `all_reduce` a
    layer forward and one backward) and updates the running statistics
    with them, so they stay equal on every rank.  The one-value-per-
    channel case is decided on the global count, which D > 1 makes at
    least D, so it does not arise there.  With ghost-batch groups as
    well, G must be a multiple of D: each rank then normalizes its G / D
    groups with no collective, and one `all_reduce` (no gradient)
    averages the running statistics' update over the D ranks, as the JAX
    package averages over all G groups; any other G raises ValueError."""

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
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        groups = _BN_GROUPS.get()
        sync = _BN_SYNC.get()
        if sync is not None:
            return self._synced(xf, groups, *sync).to(x.dtype)
        if groups > 1:
            return self._ghost(xf, groups).to(x.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            self._update(mean, var)
        if xf.numel() == xf.shape[1]:
            shape = (1, -1, 1, 1)
            a = (self.weight * torch.rsqrt(var + self.eps)).view(shape)
            return ((xf - xf.mean(dim=(0, 2, 3), keepdim=True)) * a
                    + self.bias.view(shape)).to(x.dtype)
        return F.batch_norm(xf, None, None, self.weight, self.bias, True,
                            0.0, self.eps).to(x.dtype)

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if _BN_UPDATE.get():
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean, alpha=1 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var, alpha=1 - BN_MOMENTUM)

    def _synced(self, xf: torch.Tensor, groups: int, group,
                size: int) -> torch.Tensor:
        if groups > 1:
            if groups % size:
                raise ValueError(
                    f"bn_stat_groups({groups}) over a data axis of {size} "
                    f"ranks needs a group count that is a multiple of "
                    f"{size}")
            return self._ghost(xf, groups // size, group, size)
        mean, var = _GlobalStats.apply(xf, group, size)
        self._update(mean.detach(), var.detach())
        shape = (1, -1, 1, 1)
        a = (self.weight * torch.rsqrt(var + self.eps)).view(shape)
        return (xf - mean.view(shape)) * a + self.bias.view(shape)

    def _ghost(self, xf: torch.Tensor, groups: int, group=None,
               size: int = 1) -> torch.Tensor:
        b, c = xf.shape[:2]
        if b % groups:
            raise ValueError(f"bn_stat_groups({groups}) needs a batch "
                             f"divisible by the group count, got {b}")
        xg = xf.reshape(groups, b // groups, *xf.shape[1:])
        var, mean = torch.var_mean(xg, dim=(1, 3, 4), unbiased=False)
        if _BN_UPDATE.get():
            upd = torch.stack([mean.detach().mean(0), var.detach().mean(0)])
            if size > 1:
                dist.all_reduce(upd, group=group)
                upd /= size
            self._update(upd[0], upd[1])
        shape = (groups, 1, c, 1, 1)
        a = (self.weight * torch.rsqrt(var + self.eps)).view(shape)
        y = (xg - mean.view(shape)) * a + self.bias.view(1, 1, c, 1, 1)
        return y.reshape(xf.shape)


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
