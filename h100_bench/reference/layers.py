"""Plain building blocks of the benchmark's reference models, NCHW.

A frozen copy of the port's plain arithmetic (BatchNorm at eps 1e-5 with
flax's running-statistics update, per-channel PReLU, the matrix bilinear
resize and adaptive average pool, the depthwise pyramid branches), kept
here so that a later change to the port cannot move the yardstick.  It
imports nothing of the port.

Every convolution, linear layer and matrix product (attention's two) goes
through a `Numerics` object that the model is built with: `Numerics()`
computes in the activation's dtype, as the port does; `FP8Numerics()`
rounds both operands of each to float8 e4m3 with a per-tensor scale
first, the precision below bf16 that the bf16 models' control runs in;
`TF32Numerics()` rounds them to TF32, the one below f32.  A bias is added
as it is.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax: running = 0.9 * running + 0.1 * batch
FP8_MAX = 448.0  # the largest float8 e4m3 value


class Numerics:
    """Convolutions, linear layers and matrix products in the activation's
    dtype."""

    def conv(self, x, w, bias=None, stride=1, padding=0, dilation=1,
             groups=1):
        b = None if bias is None else bias.to(x.dtype)
        return F.conv2d(x, w.to(x.dtype), b, stride, padding, dilation,
                        groups)

    def linear(self, x, w, bias=None):
        """x @ w.T + bias over x's last axis."""
        b = None if bias is None else bias.to(x.dtype)
        return F.linear(x, w.to(x.dtype), b)

    def matmul(self, a, b):
        """a @ b, batched over the leading axes."""
        return torch.matmul(a, b.to(a.dtype))


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` through float8 e4m3 at a per-tensor scale (amax -> 448), back
    in its own dtype."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    q = (t.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(t.dtype)


class FP8Numerics(Numerics):
    """Convolutions, linear layers and matrix products whose two operands
    are rounded to float8 e4m3."""

    def conv(self, x, w, bias=None, stride=1, padding=0, dilation=1,
             groups=1):
        return super().conv(fp8_round(x), fp8_round(w.to(x.dtype)), bias,
                            stride, padding, dilation, groups)

    def linear(self, x, w, bias=None):
        return super().linear(fp8_round(x), fp8_round(w.to(x.dtype)), bias)

    def matmul(self, a, b):
        return super().matmul(fp8_round(a), fp8_round(b.to(a.dtype)))


def _tf32_bits(t: torch.Tensor) -> torch.Tensor:
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


class _TF32(torch.autograd.Function):
    """TF32 rounding that rounds the gradient on its way back too."""

    @staticmethod
    def forward(ctx, t):
        return _tf32_bits(t)

    @staticmethod
    def backward(ctx, g):
        return _tf32_bits(g)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 `t` rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), as the tensor cores round their inputs."""
    return _TF32.apply(t.float())


class TF32Numerics(Numerics):
    """Convolutions, linear layers and matrix products whose two f32
    operands are rounded to TF32, the precision below f32 that the f32
    cells' control runs in."""

    def conv(self, x, w, bias=None, stride=1, padding=0, dilation=1,
             groups=1):
        return super().conv(tf32_round(x), tf32_round(w.float()), bias,
                            stride, padding, dilation, groups)

    def linear(self, x, w, bias=None):
        return super().linear(tf32_round(x), tf32_round(w.float()), bias)

    def matmul(self, a, b):
        return super().matmul(tf32_round(a), tf32_round(b.float()))


PLAIN = Numerics()


class BatchNorm(nn.BatchNorm2d):
    """Eval: running statistics.  Train: the batch's mean and biased
    variance in f32 (f64 for f64), rounded once to x's dtype; the running
    statistics move as flax moves them."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS)

    def eval_affine(self):
        a = self.weight / torch.sqrt(self.running_var + self.eps)
        return a, self.bias - self.running_mean * a

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean,
                                                     alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var,
                                                    alpha=1 - BN_MOMENTUM)
        if xf.numel() == xf.shape[1]:  # one value a channel: the bias
            shape = (1, -1, 1, 1)
            a = (self.weight * torch.rsqrt(var + self.eps)).view(shape)
            return ((xf - xf.mean(dim=(0, 2, 3), keepdim=True)) * a
                    + self.bias.view(shape)).to(x.dtype)
        return F.batch_norm(xf, None, None, self.weight, self.bias, True,
                            0.0, self.eps).to(x.dtype)


class PReLU(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x):
        return F.prelu(x, self.alpha.to(x.dtype))


class C(nn.Module):
    """Conv with padding dilation * (k - 1) // 2."""

    def __init__(self, nin, nout, k=3, stride=1, dilation=1, groups=1,
                 bias=False, num=PLAIN):
        super().__init__()
        self.conv = nn.Conv2d(nin, nout, k, stride=stride,
                              padding=dilation * (k - 1) // 2,
                              dilation=dilation, groups=groups, bias=bias)
        self.num = num

    def forward(self, x):
        c = self.conv
        return self.num.conv(x, c.weight, c.bias, c.stride, c.padding,
                             c.dilation, c.groups)


class CB(nn.Module):
    def __init__(self, nin, nout, k=3, stride=1, dilation=1, groups=1,
                 num=PLAIN):
        super().__init__()
        self.conv = C(nin, nout, k, stride, dilation, groups, num=num)
        self.bn = BatchNorm(nout)

    def forward(self, x):
        return self.bn(self.conv(x))


class CBR(nn.Module):
    def __init__(self, nin, nout, k=3, stride=1, dilation=1, groups=1,
                 num=PLAIN):
        super().__init__()
        self.cb = CB(nin, nout, k, stride, dilation, groups, num=num)
        self.act = PReLU(nout)

    def forward(self, x):
        return self.act(self.cb(x))


class BR(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.bn = BatchNorm(features)
        self.act = PReLU(features)

    def forward(self, x):
        return self.act(self.bn(x))


# --- operator matrices of the resizes and pools ---

@lru_cache(maxsize=None)
def interp_matrix(in_size: int, out_size: int,
                  align_corners: bool) -> np.ndarray:
    """Dense [out, in] linear-interpolation matrix."""
    o = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = (o * ((in_size - 1) / (out_size - 1)) if out_size > 1
               else np.zeros_like(o))
    else:
        src = (o + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    mat[np.arange(out_size), lo] += 1.0 - w_hi
    mat[np.arange(out_size), hi] += w_hi
    return mat.astype(np.float32)


@lru_cache(maxsize=None)
def adaptive_avg_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in]: bin i averages input [floor(i*I/O), ceil((i+1)*I/O))."""
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        lo = (o * in_size) // out_size
        hi = -((-(o + 1) * in_size) // out_size)
        mat[o, lo:hi] = 1.0 / (hi - lo)
    return mat.astype(np.float32)


def _mm(eq: str, mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    m = torch.from_numpy(mat).to(device=x.device, dtype=x.dtype)
    return torch.einsum(eq, m, x)


def resize_bilinear(x: torch.Tensor, size_hw: Tuple[int, int],
                    align_corners: bool = True,
                    order: str = "hw") -> torch.Tensor:
    """Bilinear resize of NCHW `x` by its two matrices, in x's dtype."""
    h_in, w_in = x.shape[2], x.shape[3]
    h_out, w_out = size_hw
    for dim in (("h", "w") if order == "hw" else ("w", "h")):
        if dim == "h" and h_in != h_out:
            x = _mm("oh,bchw->bcow", interp_matrix(h_in, h_out,
                                                   align_corners), x)
        elif dim == "w" and w_in != w_out:
            x = _mm("ow,bchw->bcho", interp_matrix(w_in, w_out,
                                                   align_corners), x)
    return x


def adaptive_avg_pool(x: torch.Tensor, size_hw: Tuple[int, int]):
    h_in, w_in = x.shape[2], x.shape[3]
    h_out, w_out = size_hw
    if h_in != h_out:
        x = _mm("oh,bchw->bcow", adaptive_avg_matrix(h_in, h_out), x)
    if w_in != w_out:
        x = _mm("ow,bchw->bcho", adaptive_avg_matrix(w_in, w_out), x)
    return x


def branch_sizes(h: int, w: int, scales: Sequence[float]):
    """Each pyramid branch's plane: ceil(size * scale), at least 5."""
    return tuple((max(int(np.ceil(h * s)), 5), max(int(np.ceil(w * s)), 5))
                 for s in scales)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(
        b, c, h, w)


def pyr_branches(x: torch.Tensor, weights: torch.Tensor,
                 scales: Sequence[float], num=PLAIN) -> torch.Tensor:
    """The five-scale branch stack: per scale, resample x, a depthwise
    3x3, resample back; x [B, P, H, W], weights [S, 3, 3, P] ->
    [B, S*P, H, W], computed in f32 (f64 for f64) and rounded once."""
    f = torch.promote_types(x.dtype, torch.float32)
    xf, wf = x.to(f), weights.to(f)
    h, w = x.shape[2], x.shape[3]
    out = []
    for i, (s, hw_s) in enumerate(zip(scales, branch_sizes(h, w, scales))):
        if s < 1.0:
            y = adaptive_avg_pool(xf, hw_s)
        elif s > 1.0:
            y = resize_bilinear(xf, hw_s, align_corners=True)
        else:
            y = xf
        taps = wf[i].permute(2, 0, 1).unsqueeze(1)  # [P, 1, 3, 3]
        y = num.conv(y, taps, padding=1, groups=y.shape[1])
        if s != 1.0:
            y = resize_bilinear(y, (h, w), align_corners=True)
        out.append(y)
    return torch.cat(out, dim=1).to(x.dtype)
