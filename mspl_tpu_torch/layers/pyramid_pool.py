"""Efficient pyramid-pool decoder blocks (port of
mspl_tpu/layers/pyramid_pool.py).

`EfficientPyrPool`: proj 1x1 CBR, a depthwise 3x3 at five scales (resample,
depthwise, resample back), concat, BN+PReLU, channel shuffle, grouped 3x3
merge CBR, 1x1 classifier (+ last BR).  `pre` is the lower-resolution
decoder tensor to upsample and add before the block.  In eval the proj conv
is commuted with that upsample, as the JAX eval path does: conv+BN is a
per-channel affine in eval and align_corners bilinear rows sum to 1, so
CBR(up(pre) + x) == PReLU(up(conv(pre) * a) + conv(x) * a + b), and the
upsample runs at proj width.  Train keeps the reference's order, x +
up(pre) and then the proj CBR: train-mode BatchNorm normalizes with the
statistics of the merged input, which must not be split.  The branch
stack goes through the `pyr_branches` kernel (differentiable in train);
with `fuse_tail` the whole eval block after the proj goes through the
`pyr_pool_fused_eval` kernel, as the JAX classifier stage (`fuse_tail`,
`channel_major_out`), while train runs the plain tail.  Either way the
output is channel-major.
`EfficientPWC`: grouped 3x3 expansion gated by a global-context sigmoid.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mspl_tpu_torch.layers.conv_blocks import BR, C, CBR
from mspl_tpu_torch.ops.pyrpool import (channel_shuffle, prelu,
                                        pyr_branches, pyr_pool_fused_eval)
from mspl_tpu_torch.ops.resize import resize_bilinear


class EfficientPyrPool(nn.Module):
    def __init__(self, nin: int, proj_features: int, out_features: int,
                 scales: Tuple[float, ...] = (2.0, 1.5, 1.0, 0.5, 0.1),
                 last_layer_br: bool = True, fuse_tail: bool = False):
        super().__init__()
        p = proj_features
        self.scales = tuple(sorted(scales, reverse=True))
        s_n = len(self.scales)
        self.fuse_tail = fuse_tail
        self.proj = CBR(nin, p, 1)
        # flax's `dw_s{i}_kernel` (3, 3, 1, P) for scale i, stacked into the
        # [S, 3, 3, P] layout the branch kernels take
        self.dw_weights = nn.Parameter(torch.randn(s_n, 3, 3, p) * (2 / 9) ** 0.5)
        self.merge_br = BR(s_n * p)
        self.merge_cbr = CBR(s_n * p, p, 3, groups=p)
        self.classify = C(p, out_features, 1, bias=not last_layer_br)
        self.last_br = BR(out_features) if last_layer_br else None

    def _proj_commuted(self, x: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
        cb = self.proj.cb
        a, beff = cb.bn.eval_affine()
        ka = cb.conv.conv.weight[:, :, 0, 0] * a[:, None]  # [P, Cin]

        def pconv(t):
            return F.conv2d(t, ka.to(t.dtype)[:, :, None, None])

        za = resize_bilinear(pconv(pre), (x.shape[2], x.shape[3]),
                             align_corners=True, order="wh")
        z = pconv(x) + za + beff.to(x.dtype).view(1, -1, 1, 1)
        return prelu(z, self.proj.act.alpha)

    def _tail_params(self):
        """Folded BN affines and weights in the fused kernel's layouts."""
        def br_affine(bn, act):
            a, b = bn.eval_affine()
            return torch.stack([a, b, act.alpha])

        cls = self.classify.conv
        o = cls.out_channels
        cls_b = cls.bias if cls.bias is not None else torch.zeros(
            o, device=cls.weight.device)
        if self.last_br is not None:
            aff3 = br_affine(self.last_br.bn, self.last_br.act)
        else:
            one = torch.ones(o, device=cls.weight.device)
            aff3 = torch.stack([one, torch.zeros_like(one), one])
        return (br_affine(self.merge_br.bn, self.merge_br.act),
                self.merge_cbr.cb.conv.conv.weight.permute(2, 3, 1, 0),
                br_affine(self.merge_cbr.cb.bn, self.merge_cbr.act),
                cls.weight[:, :, 0, 0].t(), cls_b, aff3)

    def forward(self, x: torch.Tensor,
                pre: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            if pre is not None:
                x = x + resize_bilinear(pre, (x.shape[2], x.shape[3]),
                                        align_corners=True, order="wh")
            x = self.proj(x)
        else:
            x = self.proj(x) if pre is None else self._proj_commuted(x, pre)
        if self.fuse_tail and not self.training:
            aff1, mw, aff2, cls_w, cls_b, aff3 = self._tail_params()
            return pyr_pool_fused_eval(x, self.dw_weights, aff1, mw, aff2,
                                       cls_w, cls_b, aff3, self.scales)
        out = pyr_branches(x, self.dw_weights, self.scales)
        out = self.merge_br(out)
        out = channel_shuffle(out, len(self.scales))
        out = self.classify(self.merge_cbr(out))
        if self.last_br is not None:
            out = self.last_br(out)
        return out


class EfficientPWC(nn.Module):
    """Pointwise expansion gated by a global-context sigmoid."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.wt_conv = C(nin, nout, 1)
        self.expand = CBR(nin, nout, 3, groups=math.gcd(nin, nout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.wt_conv(x.mean(dim=(2, 3), keepdim=True)))
        return self.expand(x) * gate
