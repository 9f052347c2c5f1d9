"""Plain DeepLabV3 (Chen et al., arXiv:1706.05587) with a ResNet-50 encoder
(He et al., arXiv:1512.03385) at output stride 16, the reference of the
`deeplabv3_*` configurations.

Bottleneck stages of 3, 4, 6 and 3 blocks (the last at stride 1 and
dilation 2), ASPP with 256 features (a 1x1, 3x3 at dilations 6, 12, 18 and
the image pool), and MSPL's light decoder: the ASPP output resized to the
1/4 tap, a 48-channel projection of that tap, a 3x3 fuse, the classifier
(in f32) and a resize to the input's size (bilinear, corners aligned).
Module names are the port's, so one state dict loads into both.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100_bench.reference.layers import PLAIN, BatchNorm, resize_bilinear
from h100_bench.weights import TRUNC_STD, fan_in, fixed


class Conv(nn.Conv2d):
    """Bias-free conv, padding dilation * (k - 1) // 2."""

    def __init__(self, nin, nout, k, stride=1, dilation=1, num=PLAIN):
        super().__init__(nin, nout, k, stride=stride,
                         padding=dilation * (k - 1) // 2, dilation=dilation,
                         bias=False)
        self.num = num

    def forward(self, x):
        return self.num.conv(x, self.weight, None, self.stride,
                             self.padding, self.dilation)


class Bottleneck(nn.Module):
    def __init__(self, nin, planes, stride=1, dilation=1, num=PLAIN):
        super().__init__()
        out = planes * 4
        self.conv1, self.bn1 = Conv(nin, planes, 1, num=num), BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride, dilation, num=num)
        self.bn2 = BatchNorm(planes)
        self.conv3, self.bn3 = Conv(planes, out, 1, num=num), BatchNorm(out)
        self.downsample = None
        if nin != out or stride != 1:
            self.downsample = nn.Sequential(Conv(nin, out, 1, stride,
                                                 num=num), BatchNorm(out))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class ResNetEncoder(nn.Module):
    def __init__(self, stage_blocks, width=64, num=PLAIN):
        super().__init__()
        self.stem, self.stem_bn = Conv(3, width, 7, 2, num=num), BatchNorm(
            width)
        plan = [(width, 1, 1), (width * 2, 2, 1), (width * 4, 2, 1),
                (width * 8, 1, 2)]
        nin = width
        self.stages = nn.ModuleList()
        for (planes, stride, dilation), blocks in zip(plan, stage_blocks):
            stage = nn.ModuleList()
            for bi in range(blocks):
                stage.append(Bottleneck(nin, planes, stride if bi == 0 else 1,
                                        dilation, num))
                nin = planes * 4
            self.stages.append(stage)

    def forward(self, x):
        y = F.relu(self.stem_bn(self.stem(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        low = None
        for si, stage in enumerate(self.stages):
            for blk in stage:
                y = blk(y)
            if si == 0:
                low = y
        return low, y


class ASPP(nn.Module):
    def __init__(self, nin, features=256, rates=(6, 12, 18), num=PLAIN):
        super().__init__()
        self.b0, self.bn0 = Conv(nin, features, 1, num=num), BatchNorm(
            features)
        self.bs = nn.ModuleList([Conv(nin, features, 3, 1, r, num)
                                 for r in rates])
        self.bns = nn.ModuleList([BatchNorm(features) for _ in rates])
        self.gp, self.gp_bn = Conv(nin, features, 1, num=num), BatchNorm(
            features)
        self.project = Conv(features * (len(rates) + 2), features, 1,
                            num=num)
        self.project_bn = BatchNorm(features)

    def forward(self, x):
        outs = [F.relu(self.bn0(self.b0(x)))]
        for conv, bn in zip(self.bs, self.bns):
            outs.append(F.relu(bn(conv(x))))
        g = F.relu(self.gp_bn(self.gp(x.mean(dim=(2, 3), keepdim=True))))
        outs.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        return F.relu(self.project_bn(self.project(torch.cat(outs, 1))))


class DeepLabV3(nn.Module):
    """f32 channel-major logits [B, num_classes, H, W] of NCHW input."""

    def __init__(self, num_classes, stage_blocks=(3, 4, 6, 3),
                 aspp_features=256, compute_dtype=torch.float32, num=PLAIN):
        super().__init__()
        self.compute_dtype, self.num = compute_dtype, num
        self.encoder = ResNetEncoder(stage_blocks, num=num)
        self.aspp = ASPP(2048, aspp_features, num=num)
        self.low_proj, self.low_bn = Conv(256, 48, 1, num=num), BatchNorm(48)
        self.fuse = Conv(aspp_features + 48, aspp_features, 3, num=num)
        self.fuse_bn = BatchNorm(aspp_features)
        self.classifier = nn.Conv2d(aspp_features, num_classes, 1, bias=True)

    def forward(self, x):
        low, deep = self.encoder(x.to(self.compute_dtype))
        y = resize_bilinear(self.aspp(deep), (low.shape[2], low.shape[3]))
        lo = F.relu(self.low_bn(self.low_proj(low)))
        y = F.relu(self.fuse_bn(self.fuse(torch.cat([y, lo], 1))))
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        c = self.classifier
        y = self.num.conv(y, c.weight, c.bias)
        return resize_bilinear(y, (x.shape[2], x.shape[3]))


MODEL = DeepLabV3
# the FLOP counter's ops that the whole step's share counts: the
# convolutions (their backward too); the resizes' einsums stand for the
# port's F.interpolate, which does no dense products
DENSE_OPS = ("convolution",)


def weight_law(name: str, shape):
    """Convolutions from a normal cut at 2 std, at variance 2 / fan_in (the
    classifier 1 / fan_in), BatchNorm scales 1."""
    law = fixed(name)
    if law is not None:
        return law
    if len(shape) == 4:
        scale = 1.0 if name.startswith("classifier.") else 2.0
        return "trunc", math.sqrt(scale / fan_in(shape)) / TRUNC_STD
    return "const", 1.0  # BatchNorm scale
