"""Plain ESPNetv2 segmentation model (Mehta et al., arXiv:1811.11431), the
reference of the `espnetv2_*` configurations.

The EESPNet encoder (stage plan 0/3/7/3, K = 4 dilated depthwise branches
with hierarchical feature fusion, DownSamplers with RGB reinforcement from
an average-pooled input pyramid) and the bottom-up pyramid-pool decoder of
the EdgeNets segmentation model, with the module names of the port so that
one state dict loads into both.  It follows the port's plain path op for
op: eval commutes each decoder block's 1x1 projection with the upsample of
the lower block (conv+BN is affine in eval and the resize's rows sum to
1), computes the last block's tail and the final x2 resize in f32 and
rounds once, and computes the branch stacks in f32; train keeps the
published order (add the upsampled lower block, then project).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100_bench.reference.layers import (BR, C, CB, CBR, PLAIN, PReLU,
                                         channel_shuffle, pyr_branches,
                                         resize_bilinear)
from h100_bench.weights import fan_in, fixed

SCALES = (2.0, 1.5, 1.0, 0.5, 0.1)
_STAGE_K = (4, 4, 4, 4, 4)
_STAGE_RLIM = (13, 11, 9, 7, 5)
_STAGE_REPS = (0, 3, 7, 3)


def channel_plan(s: float):
    """Stage widths for width scaler `s` (s=2.0: 32, 128, 256, 512)."""
    base_s = int(math.ceil(int(32 * s) / 4) * 4)
    c0 = 32 if base_s > 32 else base_s
    return (c0,) + tuple(base_s * 2 ** i for i in range(1, 4))


def branch_dilations(k: int, r_lim: int):
    ks = sorted((3 + 2 * i) if (3 + 2 * i) <= r_lim else 3 for i in range(k))
    return tuple((x - 1) // 2 for x in ks)


def avg_pool_3x3_s2(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


class EESP(nn.Module):
    def __init__(self, nin, nout, stride=1, k=4, r_lim=7, avg=False,
                 num=PLAIN):
        super().__init__()
        n = nout // k
        groups = k if (nin % k == 0 and n % k == 0) else 1
        self.stride, self.avg, self.num = stride, avg, num
        self.proj_1x1 = CBR(nin, n, 1, groups=groups, num=num)
        self.dilations = branch_dilations(k, r_lim)
        self.dw = nn.ParameterList([nn.Parameter(torch.empty(n, 1, 3, 3))
                                    for _ in self.dilations])
        self.br_after_cat = BR(nout)
        self.conv_1x1_exp = CB(nout, nout, 1, groups=groups, num=num)
        if not avg:
            self.module_act = PReLU(nout)

    def forward(self, x, with_pool=False):
        proj = self.proj_1x1(x)
        branches = []
        for wk, d in zip(self.dw, self.dilations):
            b = self.num.conv(proj, wk, stride=self.stride, padding=d,
                              dilation=d, groups=proj.shape[1])
            if branches:
                b = b + branches[-1]
            branches.append(b)
        expanded = self.conv_1x1_exp(self.br_after_cat(torch.cat(branches,
                                                                 1)))
        if self.avg:
            return (avg_pool_3x3_s2(x), expanded) if with_pool else expanded
        if expanded.shape == x.shape:
            expanded = expanded + x
        return self.module_act(expanded)


class DownSampler(nn.Module):
    def __init__(self, nin, nout, k=4, r_lim=9, num=PLAIN):
        super().__init__()
        self.eesp = EESP(nin, nout - nin, stride=2, k=k, r_lim=r_lim,
                         avg=True, num=num)
        self.inp_reinf_cbr = CBR(3, 3, 3, num=num)
        self.inp_reinf_cb = CB(3, nout, 1, num=num)
        self.act = PReLU(nout)

    def forward(self, x, img):
        avg_out, eesp_out = self.eesp(x, with_pool=True)
        out = torch.cat([avg_out, eesp_out], 1)
        while img.shape[2:] != out.shape[2:]:
            img = avg_pool_3x3_s2(img)
        return self.act(out + self.inp_reinf_cb(self.inp_reinf_cbr(img)))


class EESPNet(nn.Module):
    def __init__(self, s, compute_dtype, num=PLAIN):
        super().__init__()
        cfg = channel_plan(s)
        self.compute_dtype = compute_dtype
        self.level1 = CBR(3, cfg[0], 3, stride=2, num=num)
        self.level2_0 = DownSampler(cfg[0], cfg[1], _STAGE_K[0],
                                    _STAGE_RLIM[0], num)
        self.level3_0 = DownSampler(cfg[1], cfg[2], _STAGE_K[1],
                                    _STAGE_RLIM[1], num)
        self.level3_blocks = nn.ModuleList(
            [EESP(cfg[2], cfg[2], k=_STAGE_K[2], r_lim=_STAGE_RLIM[2],
                  num=num) for _ in range(_STAGE_REPS[1])])
        self.level4_0 = DownSampler(cfg[2], cfg[3], _STAGE_K[2],
                                    _STAGE_RLIM[2], num)
        self.level4_blocks = nn.ModuleList(
            [EESP(cfg[3], cfg[3], k=_STAGE_K[3], r_lim=_STAGE_RLIM[3],
                  num=num) for _ in range(_STAGE_REPS[2])])

    def encode(self, x):
        img = x.to(self.compute_dtype)
        l1 = self.level1(img)
        img4 = avg_pool_3x3_s2(avg_pool_3x3_s2(img))
        img8 = avg_pool_3x3_s2(img4)
        img16 = avg_pool_3x3_s2(img8)
        l2 = self.level2_0(l1, img4)
        l3 = self.level3_0(l2, img8)
        for blk in self.level3_blocks:
            l3 = blk(l3)
        l4 = self.level4_0(l3, img16)
        for blk in self.level4_blocks:
            l4 = blk(l4)
        return l1, l2, l3, l4


class EfficientPyrPool(nn.Module):
    def __init__(self, nin, p, nout, last_layer_br=True, f32_tail=False,
                 num=PLAIN):
        super().__init__()
        self.scales, self.f32_tail, self.num = SCALES, f32_tail, num
        self.proj = CBR(nin, p, 1, num=num)
        self.dw_weights = nn.Parameter(torch.empty(len(SCALES), 3, 3, p))
        self.merge_br = BR(len(SCALES) * p)
        self.merge_cbr = CBR(len(SCALES) * p, p, 3, groups=p, num=num)
        self.classify = C(p, nout, 1, bias=not last_layer_br, num=num)
        self.last_br = BR(nout) if last_layer_br else None

    def _proj_commuted(self, x, pre):
        """Eval: PReLU(up(conv(pre) * a) + conv(x) * a + b)."""
        cb = self.proj.cb
        a, beff = cb.bn.eval_affine()
        ka = (cb.conv.conv.weight[:, :, 0, 0] * a[:, None])[:, :, None, None]
        za = resize_bilinear(self.num.conv(pre, ka),
                             (x.shape[2], x.shape[3]), order="wh")
        z = self.num.conv(x, ka) + za + beff.to(x.dtype).view(1, -1, 1, 1)
        return F.prelu(z, self.proj.act.alpha.to(z.dtype))

    def _tail(self, x):
        out = channel_shuffle(self.merge_br(pyr_branches(
            x, self.dw_weights, self.scales, self.num)), len(self.scales))
        out = self.classify(self.merge_cbr(out))
        return out if self.last_br is None else self.last_br(out)

    def forward(self, x, pre=None):
        if self.training:
            if pre is not None:
                x = x + resize_bilinear(pre, (x.shape[2], x.shape[3]),
                                        order="wh")
            x = self.proj(x)
        else:
            x = self.proj(x) if pre is None else self._proj_commuted(x, pre)
        if self.f32_tail and not self.training:
            return self._tail(x.float()).to(x.dtype)
        return self._tail(x)


class EfficientPWC(nn.Module):
    def __init__(self, nin, nout, num=PLAIN):
        super().__init__()
        self.wt_conv = C(nin, nout, 1, num=num)
        self.expand = CBR(nin, nout, 3, groups=math.gcd(nin, nout), num=num)

    def forward(self, x):
        gate = torch.sigmoid(self.wt_conv(x.mean(dim=(2, 3), keepdim=True)))
        return self.expand(x) * gate


class ESPNetv2Segmentation(nn.Module):
    """Channel-major logits [B, num_classes, H, W] of NCHW input."""

    def __init__(self, num_classes, s=2.0, dec_base_planes=16,
                 compute_dtype=torch.float32, num=PLAIN):
        super().__init__()
        cfg = channel_plan(s)
        bp = dec_base_planes
        dec = (4 * bp, 3 * bp, 2 * bp, num_classes)
        proj = min(bp, max(num_classes // 2, 8))
        self.base_net = EESPNet(s, compute_dtype, num)
        self.bu_dec_l1 = EfficientPyrPool(cfg[3], proj, dec[0], num=num)
        self.merge_l2 = EfficientPWC(cfg[2], dec[0], num)
        self.bu_dec_l2 = EfficientPyrPool(dec[0], proj, dec[1], num=num)
        self.merge_l3 = EfficientPWC(cfg[1], dec[1], num)
        self.bu_dec_l3 = EfficientPyrPool(dec[1], proj, dec[2], num=num)
        self.merge_l4 = EfficientPWC(cfg[0], dec[2], num)
        self.bu_dec_l4 = EfficientPyrPool(dec[2], proj, dec[3],
                                          last_layer_br=False,
                                          f32_tail=True, num=num)

    def forward(self, x):
        l1, l2, l3, l4 = self.base_net.encode(x)
        out = self.bu_dec_l1(l4)
        out = self.bu_dec_l2(self.merge_l2(l3), pre=out)
        out = self.bu_dec_l3(self.merge_l3(l2), pre=out)
        out = self.bu_dec_l4(self.merge_l4(l1), pre=out)
        return resize_bilinear(out.float(), (x.shape[2], x.shape[3])
                               ).to(out.dtype)


MODEL = ESPNetv2Segmentation
# the FLOP counter's ops that the whole step's share counts: the
# convolutions (their backward too); the resizes' and pools' einsums stand
# for the port's kernel ④ and F.interpolate, which do no dense products
DENSE_OPS = ("convolution",)


def weight_law(name: str, shape):
    """He-normal convolutions (std sqrt(2 / fan_in); the pyramid's
    depthwise taps at fan-in 9), PReLU alphas 0.25, BatchNorm scales 1."""
    law = fixed(name)
    if law is not None:
        return law
    if name.endswith("dw_weights"):
        return "normal", math.sqrt(2.0 / 9.0)
    if len(shape) == 4:
        return "normal", math.sqrt(2.0 / fan_in(shape))
    if name.rsplit(".", 1)[-1] == "alpha":
        return "const", 0.25
    return "const", 1.0  # BatchNorm scale
