"""DeepLabV3 segmentation model (port of mspl_tpu/models/deeplab.py), NCHW.

A ResNet-50-style bottleneck encoder at output stride 16 (stem 7x7/s2 and
a 3x3/s2 max pool, four stages, the last at stride 1 and dilation 2), an
ASPP head (a 1x1 conv, three 3x3 convs at dilations 6, 12, 18 and an
image-pooling branch, concatenated and projected) and a light decoder:
the ASPP output resized to the 1/4 tap (bilinear, align_corners), a
48-channel projection of that tap, a 3x3 fuse, the classifier and a resize
to the input's size.  It emits f32 [B, num_classes, H, W] logits.

Module and parameter names are the reference torch layout (the JAX
package's torch twin of this model): `encoder.stem`, `encoder.stem_bn`,
`encoder.stages[si][bi].conv1 ... downsample`, `aspp.b0 ... project_bn`,
`low_proj`, `low_bn`, `fuse`, `fuse_bn`, `classifier`, so `state_dict()`
has the twin's keys and shapes.  `utils/flax_bridge.py` loads the JAX
model's variable tree into it.

`compute_dtype=torch.bfloat16` keeps the parameters in f32 and runs every
conv and BatchNorm in bf16 (flax's `dtype=x.dtype`), but the classifier,
which flax promotes against its f32 parameters, and the final resize run
in f32.  BatchNorm is `layers/conv_blocks.py`'s (eps 1e-5, flax's
momentum 0.9 and biased variance), which normalizes the image pool's one
value per channel in train as flax does.  No kernel of the port runs
here: cuDNN carries the convolutions, as XLA does in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mspl_tpu_torch.layers.conv_blocks import BatchNorm
from mspl_tpu_torch.ops.resize import resize_bilinear

# the reference's _BN: BatchNorm at eps 1e-5 and momentum 0.9, computed in
# f32 and rounded once to the activation's dtype
_BN = BatchNorm


class _Conv(nn.Conv2d):
    """Bias-free conv, padding dilation * (k - 1) // 2 on both sides, run
    in the activation's dtype (the reference's _Conv)."""

    def __init__(self, nin: int, nout: int, k: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__(nin, nout, k, stride=stride,
                         padding=dilation * (k - 1) // 2, dilation=dilation,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding, self.dilation)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 (x4) with a projected residual
    where the channels or the stride change."""

    expansion = 4

    def __init__(self, nin: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = _Conv(nin, planes, 1)
        self.bn1 = _BN(planes)
        self.conv2 = _Conv(planes, planes, 3, stride, dilation)
        self.bn2 = _BN(planes)
        self.conv3 = _Conv(planes, out_ch, 1)
        self.bn3 = _BN(out_ch)
        self.downsample = None
        if nin != out_ch or stride != 1:
            self.downsample = nn.Sequential(_Conv(nin, out_ch, 1, stride),
                                            _BN(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class ResNetEncoder(nn.Module):
    """ResNet-50-style bottleneck encoder, output stride 16; `forward`
    returns the 1/4 tap (after stage 0) and the deep features."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, in_channels: int = 3):
        super().__init__()
        self.stem = _Conv(in_channels, width, 7, 2)
        self.stem_bn = _BN(width)
        plan = [(width, 1, 1), (width * 2, 2, 1), (width * 4, 2, 1),
                (width * 8, 1, 2)]  # (planes, stride, dilation) a stage
        nin = width
        self.stages = nn.ModuleList()
        for (planes, stride, dilation), blocks in zip(plan, stage_blocks):
            stage = nn.ModuleList()
            for bi in range(blocks):
                stage.append(Bottleneck(nin, planes,
                                        stride=stride if bi == 0 else 1,
                                        dilation=dilation))
                nin = planes * Bottleneck.expansion
            self.stages.append(stage)

    def forward(self, x: torch.Tensor):
        y = F.relu(self.stem_bn(self.stem(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)  # pads with -inf
        low = None
        for si, stage in enumerate(self.stages):
            for blk in stage:
                y = blk(y)
            if si == 0:
                low = y
        return low, y


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: 1x1, three dilated 3x3 and the image
    pool (mean over the plane, 1x1, BN, ReLU, broadcast), projected."""

    def __init__(self, nin: int, features: int = 256,
                 rates: Sequence[int] = (6, 12, 18)):
        super().__init__()
        self.b0 = _Conv(nin, features, 1)
        self.bn0 = _BN(features)
        self.bs = nn.ModuleList([_Conv(nin, features, 3, 1, r)
                                 for r in rates])
        self.bns = nn.ModuleList([_BN(features) for _ in rates])
        self.gp = _Conv(nin, features, 1)
        self.gp_bn = _BN(features)
        self.project = _Conv(features * (len(rates) + 2), features, 1)
        self.project_bn = _BN(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [F.relu(self.bn0(self.b0(x)))]
        for conv, bn in zip(self.bs, self.bns):
            outs.append(F.relu(bn(conv(x))))
        g = x.mean(dim=(2, 3), keepdim=True)
        g = F.relu(self.gp_bn(self.gp(g)))
        outs.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        return F.relu(self.project_bn(self.project(torch.cat(outs, dim=1))))


class DeepLabV3(nn.Module):
    """DeepLabV3 (ResNet encoder + ASPP + light decoder): NCHW input, f32
    channel-major logits [B, num_classes, H, W].  `in_channels` is the
    image's channel count (4 for RGB-D), which flax reads from its
    input."""

    def __init__(self, num_classes: int,
                 stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 aspp_features: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 in_channels: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.encoder = ResNetEncoder(stage_blocks, in_channels=in_channels)
        width = 64 * Bottleneck.expansion  # the encoder's stage-0 output
        self.aspp = ASPP(8 * width, aspp_features)
        self.low_proj = _Conv(width, 48, 1)
        self.low_bn = _BN(48)
        self.fuse = _Conv(aspp_features + 48, aspp_features, 3)
        self.fuse_bn = _BN(aspp_features)
        # flax promotes this conv against its f32 parameters: it runs in f32
        self.classifier = nn.Conv2d(aspp_features, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        low, deep = self.encoder(x.to(self.compute_dtype))
        y = self.aspp(deep)
        y = resize_bilinear(y, (low.shape[2], low.shape[3]),
                            align_corners=True)
        lo = F.relu(self.low_bn(self.low_proj(low)))
        y = F.relu(self.fuse_bn(self.fuse(torch.cat([y, lo], dim=1))))
        y = self.classifier(y.to(torch.float32))
        return resize_bilinear(y, (x.shape[2], x.shape[3]),
                               align_corners=True)
