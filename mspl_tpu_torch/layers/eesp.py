"""EESP unit and strided DownSampler (port of mspl_tpu/layers/eesp.py).

EESP: grouped 1x1 CBR reduce to n = nout/K, K dilated depthwise 3x3 branches
with hierarchical feature fusion (cumulative adds), concat, BN+PReLU,
grouped 1x1 CB expand, residual add when shapes match, PReLU.  The strided
variant (`down_method='avg'`) skips the residual; `DownSampler` concatenates
it with a 3x3/s2 average pool and adds the RGB reinforcement branch.  The
depthwise branches are native grouped convolutions by default;
`use_pallas=True` sends a stride-1 unit's branch stack + HFF to the CUDA
kernel of `ops/eesp_branches.py`, as the JAX package's flag sends it to its
Pallas kernel.  The parameter tree is the same either way.  Both units run
in train mode (BatchNorm on batch statistics) on the native route; the
kernel route is eval only, since its TPU kernel has no VJP.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mspl_tpu_torch.layers.conv_blocks import BR, CB, CBR, PReLU
from mspl_tpu_torch.ops.eesp_branches import eesp_branches


def branch_dilations(k: int, r_lim: int) -> Tuple[int, ...]:
    """Effective-kernel-size -> dilation schedule for the K branches."""
    ksizes = []
    for i in range(k):
        ksize = 3 + 2 * i
        ksizes.append(ksize if ksize <= r_lim else 3)
    ksizes.sort()
    return tuple((ks - 1) // 2 for ks in ksizes)


def _avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    # AvgPool2d(3, stride=2, padding=1, count_include_pad=True)
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


class EESP(nn.Module):
    """Extremely Efficient Spatial Pyramid unit."""

    def __init__(self, nin: int, nout: int, stride: int = 1, k: int = 4,
                 r_lim: int = 7, down_method: str = "esp",
                 use_pallas: bool = False):
        super().__init__()
        self.use_pallas = use_pallas
        n = nout // k
        if n * k != nout:
            raise ValueError(f"EESP nout={nout} must be divisible by k={k}")
        self.stride = stride
        self.avg = stride == 2 and down_method == "avg"
        groups = k if (nin % k == 0 and n % k == 0) else 1
        self.proj_1x1 = CBR(nin, n, 1, groups=groups)
        self.dilations = branch_dilations(k, r_lim)
        # branch i is flax's `dw_d{i}_kernel`, as a depthwise OIHW weight
        self.dw = nn.ParameterList(
            [nn.Parameter(torch.empty(n, 1, 3, 3)) for _ in self.dilations])
        for wk in self.dw:
            nn.init.kaiming_normal_(wk, nonlinearity="relu")
        self.br_after_cat = BR(nout)
        self.conv_1x1_exp = CB(nout, nout, 1, groups=groups)
        if not self.avg:
            self.module_act = PReLU(nout)

    def forward(self, x: torch.Tensor, with_pool: bool = False):
        proj = self.proj_1x1(x)
        # The DownSampler front kernel (ops/eesp_branches.py::down_front)
        # stays unrouted, as in the JAX package (mspl_tpu/layers/eesp.py:111,
        # `fused_front = False`): there it ran ~4x slower than the lax path,
        # so no path of the reference takes it.  Strided units keep
        # F.conv2d whatever `use_pallas` says.
        if self.use_pallas and self.stride == 1:
            if self.training:
                raise NotImplementedError(
                    "use_pallas routes an EESP unit through the eval-only "
                    "branch kernel (its TPU kernel, pallas_eesp.py, has no "
                    "VJP); train with use_pallas=False")
            # the K kernels in the kernel's [K, 3, 3, n] layout, stacked on
            # their own device (no host round trip)
            taps = torch.stack([wk[:, 0] for wk in self.dw])
            taps = taps.permute(0, 2, 3, 1)
            merged = eesp_branches(proj, taps, self.dilations)
        else:
            branches = []
            for wk, d in zip(self.dw, self.dilations):
                b = F.conv2d(proj, wk.to(proj.dtype), stride=self.stride,
                             padding=d, dilation=d, groups=proj.shape[1])
                if branches:  # hierarchical feature fusion
                    b = b + branches[-1]
                branches.append(b)
            merged = torch.cat(branches, dim=1)
        merged = self.br_after_cat(merged)
        expanded = self.conv_1x1_exp(merged)
        if self.avg:
            if with_pool:
                return _avg_pool_3x3_s2(x), expanded
            return expanded
        if expanded.shape == x.shape:
            expanded = expanded + x
        return self.module_act(expanded)


class DownSampler(nn.Module):
    """Strided EESP ++ avg-pool shortcut ++ input reinforcement from the
    `img_ch`-channel image (RGB, or RGB-D with 4)."""

    def __init__(self, nin: int, nout: int, k: int = 4, r_lim: int = 9,
                 reinf: bool = True, img_ch: int = 3):
        super().__init__()
        if nout <= nin:
            raise ValueError(f"DownSampler needs nout({nout}) > nin({nin})")
        self.eesp = EESP(nin, nout - nin, stride=2, k=k, r_lim=r_lim,
                         down_method="avg")
        self.reinf = reinf
        if reinf:
            self.inp_reinf_cbr = CBR(img_ch, img_ch, 3)
            self.inp_reinf_cb = CB(img_ch, nout, 1)
        self.act = PReLU(nout)

    def forward(self, x: torch.Tensor,
                img: Optional[torch.Tensor] = None) -> torch.Tensor:
        avg_out, eesp_out = self.eesp(x, with_pool=True)
        out = torch.cat([avg_out, eesp_out], dim=1)
        if self.reinf and img is not None:
            while img.shape[2:] != out.shape[2:]:
                img = _avg_pool_3x3_s2(img)
            out = out + self.inp_reinf_cb(self.inp_reinf_cbr(img))
        return self.act(out)
