"""ESPNetv2 encoder, classifier and segmentation model (port of
mspl_tpu/models/espnetv2.py), NCHW.

`EESPNet.encode` returns the stride-2/4/8/16 taps (stage plan 0/3/7/3, RGB
reinforcement from a shared input pyramid).  `EESPNet(num_classes=N)` is
also the classifier of encoder pretraining, `forward(x, rng)`: level5 (a
DownSampler without reinforcement, 3 EESP units at r_lim 5, a depthwise
3x3 CBR and a grouped 1x1 CBR expansion), a global mean, dropout at
`drop_rate` with its mask drawn from the generator `rng` in train, and a
linear classifier, f32 logits [B, N].  The head is built only when
`num_classes` is given (flax's uncalled head allocates nothing; a torch
module allocates in its constructor), so a segmentation model's
`base_net` holds the encoder alone.  `copy_encoder` copies a classifier's
encoder into a segmentation model.  `ESPNetv2Segmentation` runs the
bottom-up decoder and emits channel-major [B, C, H, W] logits: the
classifier stage is the fused pyramid-pool kernel and the final x2 upsample
the resize kernel, as the JAX model with `channel_major_logits=True`.
`compute_dtype=torch.bfloat16` keeps the parameters in f32 and runs the
activations in bf16; the segmentation logits come out in bf16.
`in_channels` is the image's channel count (4 for RGB-D), as the JAX model
reads it from its input.

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
reference's do (`fuse and not train`).  The classifier's level5 units
honour `use_pallas`; `fuse_stages` leaves them unit by unit, as the
reference does.  The parameter tree is the same for every flag.

`stack` (ensemble weight stacking, `layers/stacking.py`) runs `stack`
models of one architecture as one forward, channels m-major: the stem
reads the shared image with `stack` times the outputs, every other layer
runs grouped by model, and the logits carry stack * num_classes channels
(heads of other widths are padded to num_classes when their trees are
stacked, `stack_variables`).  `fuse_stages` does not take it and the
classifier head does not either (ValueError, as the reference's).
`final_resize=False` returns the logits at the decoder's resolution
[B, C, H/2, W/2], in eval and in train, before the x2 resize, which then
does not run (the decoder-resolution fusion of
`pseudo/generate.py::fused_pseudo_soft_decoder_res`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

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


_ENCODER = ("level1", "level2_0", "level3_0", "level3_blocks", "level4_0",
            "level4_blocks")


class EESPNet(nn.Module):
    """ESPNetv2 backbone: a segmentation encoder (`encode`) and, with
    `num_classes`, the classifier of encoder pretraining (`forward`)."""

    def __init__(self, s: float = 2.0, reinf: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False, fuse_stages: bool = False,
                 in_channels: int = 3, num_classes: Optional[int] = None,
                 drop_rate: float = 0.2, stack: int = 1):
        super().__init__()
        if stack > 1 and fuse_stages:
            raise ValueError("fuse_stages (experimental) does not support "
                             "ensemble stacking")
        if stack > 1 and num_classes is not None:
            raise ValueError("the classification head does not support "
                             "ensemble stacking (pretraining-only path)")
        cfg = eespnet_channel_plan(s)
        self.num_classes = num_classes
        self.drop_rate = drop_rate
        self.reinf = reinf
        self.compute_dtype = compute_dtype
        self.fuse_stages = fuse_stages
        self.level1 = CBR(in_channels, cfg[0] * stack, 3, stride=2)
        self.level2_0 = DownSampler(cfg[0], cfg[1], k=_STAGE_K[0],
                                    r_lim=_STAGE_RLIM[0], reinf=reinf,
                                    img_ch=in_channels, stack=stack)
        self.level3_0 = DownSampler(cfg[1], cfg[2], k=_STAGE_K[1],
                                    r_lim=_STAGE_RLIM[1], reinf=reinf,
                                    img_ch=in_channels, stack=stack)
        self.level3_blocks = nn.ModuleList(
            [EESP(cfg[2], cfg[2], k=_STAGE_K[2], r_lim=_STAGE_RLIM[2],
                  use_pallas=use_pallas, stack=stack)
             for _ in range(_STAGE_REPS[1])])
        self.level4_0 = DownSampler(cfg[2], cfg[3], k=_STAGE_K[2],
                                    r_lim=_STAGE_RLIM[2], reinf=reinf,
                                    img_ch=in_channels, stack=stack)
        self.level4_blocks = nn.ModuleList(
            [EESP(cfg[3], cfg[3], k=_STAGE_K[3], r_lim=_STAGE_RLIM[3],
                  use_pallas=use_pallas, stack=stack)
             for _ in range(_STAGE_REPS[2])])
        if num_classes is None:
            return
        self.level5_0 = DownSampler(cfg[3], cfg[4], k=_STAGE_K[3],
                                    r_lim=_STAGE_RLIM[3], reinf=False)
        self.level5_blocks = nn.ModuleList(
            [EESP(cfg[4], cfg[4], k=_STAGE_K[4], r_lim=_STAGE_RLIM[4],
                  use_pallas=use_pallas)
             for _ in range(_STAGE_REPS[3])])
        self.level5_dw = CBR(cfg[4], cfg[4], 3, groups=cfg[4])
        self.level5_exp = CBR(cfg[4], cfg[5], 1, groups=_STAGE_K[4])
        self.classifier = nn.Linear(cfg[5], num_classes)

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

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Class logits, f32 [B, num_classes], of NCHW `x`.  In train with
        `drop_rate` > 0, dropout keeps each pooled feature with probability
        1 - drop_rate and scales the kept ones by 1 / (1 - drop_rate); its
        mask is drawn from `rng` (a generator on any device: a CPU one
        seeds a generator on x's device), for the global batch whose rows
        [offset, offset + B) `x` is where `rows` = (offset, global batch)
        says so (a mesh's data slice)."""
        if self.num_classes is None:
            raise ValueError("this EESPNet is an encoder (`encode`); build "
                             "it with num_classes for the classifier")
        l5 = self.level5_0(self.encode(x)[3])
        for blk in self.level5_blocks:
            l5 = blk(l5)
        l5 = self.level5_exp(self.level5_dw(l5))
        pooled = l5.mean(dim=(2, 3))
        if self.training and self.drop_rate > 0.0:
            pooled = dropout(pooled, self.drop_rate, rng, rows)
        # flax's Dense promotes a bf16 input against its f32 parameters
        p = pooled.to(torch.promote_types(pooled.dtype, torch.float32))
        fc = self.classifier
        return F.linear(p, fc.weight.to(p.dtype), fc.bias.to(p.dtype))


def dropout(x: torch.Tensor, rate: float,
            rng: Optional[torch.Generator],
            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """`x` with each element kept with probability 1 - `rate` and scaled by
    1 / (1 - rate), the mask drawn from `rng` on x's device (a generator
    on another device seeds one there from a draw of its own); with
    `rows` (offset, global batch), drawn for the global batch and its
    rows [offset, offset + B) taken."""
    if rng is None:
        raise ValueError("dropout in train needs a generator")
    if rng.device != x.device:
        seed = int(torch.randint(2 ** 62, (1,), generator=rng))
        rng = torch.Generator(x.device).manual_seed(seed)
    start, total = (0, x.shape[0]) if rows is None else rows
    u = torch.rand((total, *x.shape[1:]), generator=rng, device=x.device)
    keep = u[start:start + x.shape[0]] >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def copy_encoder(seg: nn.Module, cls: EESPNet) -> None:
    """Copy the classifier `cls`'s encoder (levels 1-4: parameters and
    BatchNorm statistics) into the segmentation model `seg`'s `base_net`,
    in place; raises on a missing key or a shape that differs."""
    src = {k: v for k, v in cls.state_dict().items()
           if k.split(".", 1)[0] in _ENCODER}
    seg.base_net.load_state_dict(src, strict=True)


class ESPNetv2Segmentation(nn.Module):
    """ESPNetv2 segmentation model: encoder + bottom-up decoder, emitting
    channel-major logits [B, stack * num_classes, H, W] from NCHW input
    (at H/2 x W/2 with `final_resize=False`)."""

    def __init__(self, num_classes: int, s: float = 2.0,
                 dec_base_planes: int = 16,
                 compute_dtype: torch.dtype = torch.float32,
                 channel_major_logits: bool = True,
                 use_pallas: bool = False, fuse_stages: bool = False,
                 in_channels: int = 3, stack: int = 1,
                 final_resize: bool = True):
        super().__init__()
        if not channel_major_logits:
            raise ValueError("the port's logits are channel-major (NCHW); "
                             "channel_major_logits=False has no counterpart")
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.stack = stack
        self.final_resize = final_resize
        cfg = eespnet_channel_plan(s)
        bp = dec_base_planes
        dec = (4 * bp, 3 * bp, 2 * bp, num_classes)
        # floor of 8 keeps the depthwise pyramid wide enough for tiny heads
        proj = min(bp, max(num_classes // 2, 8))
        self.base_net = EESPNet(s=s, reinf=True, compute_dtype=compute_dtype,
                                use_pallas=use_pallas,
                                fuse_stages=fuse_stages,
                                in_channels=in_channels, stack=stack)
        self.bu_dec_l1 = EfficientPyrPool(cfg[3], proj, dec[0], stack=stack)
        self.merge_l2 = EfficientPWC(cfg[2], dec[0], stack=stack)
        self.bu_dec_l2 = EfficientPyrPool(dec[0], proj, dec[1], stack=stack)
        self.merge_l3 = EfficientPWC(cfg[1], dec[1], stack=stack)
        self.bu_dec_l3 = EfficientPyrPool(dec[1], proj, dec[2], stack=stack)
        self.merge_l4 = EfficientPWC(cfg[0], dec[2], stack=stack)
        self.bu_dec_l4 = EfficientPyrPool(dec[2], proj, dec[3],
                                          last_layer_br=False, fuse_tail=True,
                                          stack=stack)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        l1, l2, l3, l4 = self.base_net.encode(x)
        out = self.bu_dec_l1(l4)
        out = self.bu_dec_l2(self.merge_l2(l3), pre=out)
        out = self.bu_dec_l3(self.merge_l3(l2), pre=out)
        out = self.bu_dec_l4(self.merge_l4(l1), pre=out)  # [B, C, H/2, W/2]
        if not self.final_resize:
            return out
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
