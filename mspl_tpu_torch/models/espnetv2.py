"""ESPNetv2 encoder and segmentation model (port of
mspl_tpu/models/espnetv2.py), eval mode, NCHW.

`EESPNet.encode` returns the stride-2/4/8/16 taps (stage plan 0/3/7/3, RGB
reinforcement from a shared input pyramid).  `ESPNetv2Segmentation` runs the
bottom-up decoder and emits channel-major [B, C, H, W] logits: the
classifier stage is the fused pyramid-pool kernel and the final x2 upsample
the resize kernel, as the JAX model with `channel_major_logits=True`.
`compute_dtype=torch.bfloat16` keeps the parameters in f32 and runs the
activations in bf16; the logits come out in bf16.  `in_channels` is the
image's channel count (4 for RGB-D), as the JAX model reads it from its
input.  The classification head (ImageNet pretraining) belongs to a later
slice.

Train mode (`model.train()`) runs BatchNorm on batch statistics, the
decoder in the reference's train order (`layers/pyramid_pool.py`), the
branch stack through the differentiable `pyr_branches`, and the final x2
resize as the plain matrix resize, as the JAX model's train forward takes
`resize_bilinear` outside any kernel; eval keeps the resize kernel.

Encoder routes, as the JAX model's flags: `use_pallas=True` sends each
stride-1 EESP unit's branch stack to the kernel of `ops/eesp_branches.py`;
`fuse_stages=True` runs each stride-1 stage (level3, level4) through the
fused-stage kernel of `ops/eesp_stage.py` and takes precedence over
`use_pallas` there; in train the stages run unit by unit, as the
reference's do (`fuse and not train`).  The parameter tree is the same
for every flag.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from mspl_tpu_torch.layers.conv_blocks import CBR
from mspl_tpu_torch.layers.eesp import (EESP, DownSampler, _avg_pool_3x3_s2,
                                        branch_dilations)
from mspl_tpu_torch.layers.pyramid_pool import EfficientPWC, EfficientPyrPool
from mspl_tpu_torch.ops.eesp_stage import (eesp_block_params,
                                           eesp_stage_fused_eval)
from mspl_tpu_torch.ops.resize_x2 import resize_x2_cm, resize_x2_cm_plain


def eespnet_channel_plan(s: float) -> Tuple[int, ...]:
    """Stage channel plan for width scaler `s` (s=2.0 -> 32, 128, 256, 512,
    1024 encoder + 1280 classifier expansion)."""
    k = 4
    base = 32
    base_s = int(math.ceil(int(base * s) / k) * k)
    c0 = base if base_s > base else base_s
    plan = [c0] + [base_s * (2 ** i) for i in range(1, 5)]
    plan.append(1024 if s <= 1.5 else 1280)
    return tuple(plan)


# per-stage branch counts and receptive-field limits
_STAGE_K = (4, 4, 4, 4, 4)
_STAGE_RLIM = (13, 11, 9, 7, 5)
_STAGE_REPS = (0, 3, 7, 3)


class EESPNet(nn.Module):
    """ESPNetv2 backbone as a segmentation encoder (`encode`)."""

    def __init__(self, s: float = 2.0, reinf: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False, fuse_stages: bool = False,
                 in_channels: int = 3):
        super().__init__()
        cfg = eespnet_channel_plan(s)
        self.reinf = reinf
        self.compute_dtype = compute_dtype
        self.fuse_stages = fuse_stages
        self.level1 = CBR(in_channels, cfg[0], 3, stride=2)
        self.level2_0 = DownSampler(cfg[0], cfg[1], k=_STAGE_K[0],
                                    r_lim=_STAGE_RLIM[0], reinf=reinf,
                                    img_ch=in_channels)
        self.level3_0 = DownSampler(cfg[1], cfg[2], k=_STAGE_K[1],
                                    r_lim=_STAGE_RLIM[1], reinf=reinf,
                                    img_ch=in_channels)
        self.level3_blocks = nn.ModuleList(
            [EESP(cfg[2], cfg[2], k=_STAGE_K[2], r_lim=_STAGE_RLIM[2],
                  use_pallas=use_pallas)
             for _ in range(_STAGE_REPS[1])])
        self.level4_0 = DownSampler(cfg[2], cfg[3], k=_STAGE_K[2],
                                    r_lim=_STAGE_RLIM[2], reinf=reinf,
                                    img_ch=in_channels)
        self.level4_blocks = nn.ModuleList(
            [EESP(cfg[3], cfg[3], k=_STAGE_K[3], r_lim=_STAGE_RLIM[3],
                  use_pallas=use_pallas)
             for _ in range(_STAGE_REPS[2])])

    def _run_stage(self, x: torch.Tensor, blocks: nn.ModuleList, k: int,
                   r_lim: int) -> torch.Tensor:
        """A stride-1 EESP stage: the fused-stage kernel when `fuse_stages`
        is set in eval, unit by unit otherwise."""
        if blocks and self.fuse_stages and not self.training:
            return eesp_stage_fused_eval(
                x, [eesp_block_params(blk) for blk in blocks],
                branch_dilations(k, r_lim))
        for blk in blocks:
            x = blk(x)
        return x

    def encode(self, x: torch.Tensor):
        """Encoder taps at strides 2, 4, 8, 16 of NCHW `x`."""
        img = x.to(self.compute_dtype)
        l1 = self.level1(img)
        # shared input pyramid: each DownSampler's reinforcement branch takes
        # the image at its own resolution, pooled once here
        img4 = _avg_pool_3x3_s2(_avg_pool_3x3_s2(img)) if self.reinf else img
        img8 = _avg_pool_3x3_s2(img4) if self.reinf else img
        img16 = _avg_pool_3x3_s2(img8) if self.reinf else img
        l2 = self.level2_0(l1, img4)
        l3 = self.level3_0(l2, img8)
        l3 = self._run_stage(l3, self.level3_blocks, _STAGE_K[2],
                             _STAGE_RLIM[2])
        l4 = self.level4_0(l3, img16)
        l4 = self._run_stage(l4, self.level4_blocks, _STAGE_K[3],
                             _STAGE_RLIM[3])
        return l1, l2, l3, l4


class ESPNetv2Segmentation(nn.Module):
    """ESPNetv2 segmentation model: encoder + bottom-up decoder, emitting
    channel-major logits [B, num_classes, H, W] from NCHW input."""

    def __init__(self, num_classes: int, s: float = 2.0,
                 dec_base_planes: int = 16,
                 compute_dtype: torch.dtype = torch.float32,
                 channel_major_logits: bool = True,
                 use_pallas: bool = False, fuse_stages: bool = False,
                 in_channels: int = 3):
        super().__init__()
        if not channel_major_logits:
            raise ValueError("the port's logits are channel-major (NCHW); "
                             "channel_major_logits=False has no counterpart")
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        cfg = eespnet_channel_plan(s)
        bp = dec_base_planes
        dec = (4 * bp, 3 * bp, 2 * bp, num_classes)
        # floor of 8 keeps the depthwise pyramid wide enough for tiny heads
        proj = min(bp, max(num_classes // 2, 8))
        self.base_net = EESPNet(s=s, reinf=True, compute_dtype=compute_dtype,
                                use_pallas=use_pallas,
                                fuse_stages=fuse_stages,
                                in_channels=in_channels)
        self.bu_dec_l1 = EfficientPyrPool(cfg[3], proj, dec[0])
        self.merge_l2 = EfficientPWC(cfg[2], dec[0])
        self.bu_dec_l2 = EfficientPyrPool(dec[0], proj, dec[1])
        self.merge_l3 = EfficientPWC(cfg[1], dec[1])
        self.bu_dec_l3 = EfficientPyrPool(dec[1], proj, dec[2])
        self.merge_l4 = EfficientPWC(cfg[0], dec[2])
        self.bu_dec_l4 = EfficientPyrPool(dec[2], proj, dec[3],
                                          last_layer_br=False, fuse_tail=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        l1, l2, l3, l4 = self.base_net.encode(x)
        out = self.bu_dec_l1(l4)
        out = self.bu_dec_l2(self.merge_l2(l3), pre=out)
        out = self.bu_dec_l3(self.merge_l3(l2), pre=out)
        out = self.bu_dec_l4(self.merge_l4(l1), pre=out)  # [B, C, H/2, W/2]
        resize = resize_x2_cm_plain if self.training else resize_x2_cm
        return resize(out, (x.shape[2], x.shape[3]), align_corners=True)


def init_random(model: nn.Module, generator: Optional[torch.Generator] = None
                ) -> nn.Module:
    """He-normal conv weights (std sqrt(2 / fan_in), flax's initializer
    family), zero biases, BatchNorm at identity statistics and PReLU alphas
    at 0.25, drawn on the CPU from `generator` so a seed gives the same
    weights on every device."""
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("dw_weights"):  # [S, 3, 3, P]: fan_in 9
                std = (2.0 / 9.0) ** 0.5
            elif prm.dim() == 4:  # OIHW conv weight
                std = (2.0 / (prm.shape[1] * prm.shape[2] * prm.shape[3])) ** 0.5
            elif leaf == "alpha":
                prm.fill_(0.25)
                continue
            elif leaf == "weight":  # BatchNorm scale
                prm.fill_(1.0)
                continue
            else:
                prm.zero_()
                continue
            prm.copy_(torch.randn(prm.shape, generator=generator) * std)
        for buf_name, buf in model.named_buffers():
            if buf_name.endswith("running_mean"):
                buf.zero_()
            elif buf_name.endswith("running_var"):
                buf.fill_(1.0)
    return model
