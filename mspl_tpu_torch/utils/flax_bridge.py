"""Load a flax variable tree of the JAX package into the port's modules.

`load_flax_variables(model, variables)` takes the `{"params",
"batch_stats"}` tree of `mspl_tpu.models.ESPNetv2Segmentation` as nested
dicts of numpy arrays (the caller converts JAX arrays with `np.asarray`;
this package never imports JAX) and copies every leaf into the matching
parameter or buffer of the port's `ESPNetv2Segmentation`, in place.

A tree of an RGB-D model (a 4-channel stem) loads into a model built with
`in_channels=4`; a tree and a model of different channel counts raise on
the stem's shape.

Conversions: conv kernels HWIO -> OIHW (grouped ones included: flax keeps
them as (kh, kw, cin/groups, cout), torch as (cout, cin/groups, kh, kw));
an EESP depthwise kernel `dw_d{i}` (3, 3, 1, n) -> (n, 1, 3, 3); the
pyramid-pool branch kernels `dw_s{i}` (3, 3, 1, P), indexed by the scales
sorted in descending order, stack into the [S, 3, 3, P] layout of the
branch kernels; the `merge_cbr` kernel (3, 3, S, P) is the grouped merge
after the channel shuffle, (P, S, 3, 3) in torch.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mspl_tpu_torch.layers.conv_blocks import BR, C, CB, CBR, BatchNorm, PReLU
from mspl_tpu_torch.layers.eesp import EESP, DownSampler
from mspl_tpu_torch.layers.pyramid_pool import EfficientPWC, EfficientPyrPool


def _copy(dst: torch.Tensor, src, what: str) -> None:
    t = torch.from_numpy(np.asarray(src, np.float32))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: flax shape {tuple(t.shape)} != port shape "
                         f"{tuple(dst.shape)}")
    dst.copy_(t)


def _hwio(dst: torch.Tensor, kernel, what: str) -> None:
    _copy(dst, np.transpose(np.asarray(kernel), (3, 2, 0, 1)), what)


def _c(mod: C, p: Mapping, what: str) -> None:
    leaf = p["Conv_0"]
    _hwio(mod.conv.weight, leaf["kernel"], what)
    if mod.conv.bias is not None:
        _copy(mod.conv.bias, leaf["bias"], what + ".bias")


def _bn(mod: BatchNorm, p: Mapping, s: Mapping, what: str) -> None:
    _copy(mod.weight, p["scale"], what + ".scale")
    _copy(mod.bias, p["bias"], what + ".bias")
    _copy(mod.running_mean, s["mean"], what + ".mean")
    _copy(mod.running_var, s["var"], what + ".var")


def _prelu(mod: PReLU, p: Mapping, what: str) -> None:
    _copy(mod.alpha, p["alpha"], what + ".alpha")


def _cb(mod: CB, p: Mapping, s: Mapping, what: str) -> None:
    _c(mod.conv, p["C_0"], what)
    _bn(mod.bn, p["BatchNorm_0"], s["BatchNorm_0"], what)


def _cbr(mod: CBR, p: Mapping, s: Mapping, what: str) -> None:
    _cb(mod.cb, p["CB_0"], s["CB_0"], what)
    _prelu(mod.act, p["PReLU_0"], what)


def _br(mod: BR, p: Mapping, s: Mapping, what: str) -> None:
    _bn(mod.bn, p["BatchNorm_0"], s["BatchNorm_0"], what)
    _prelu(mod.act, p["PReLU_0"], what)


def _eesp(mod: EESP, p: Mapping, s: Mapping, what: str) -> None:
    _cbr(mod.proj_1x1, p["proj_1x1"], s["proj_1x1"], what + ".proj_1x1")
    for i, wk in enumerate(mod.dw):
        _hwio(wk, p[f"dw_d{i}_kernel"], f"{what}.dw_d{i}")
    _br(mod.br_after_cat, p["br_after_cat"], s["br_after_cat"],
        what + ".br_after_cat")
    _cb(mod.conv_1x1_exp, p["conv_1x1_exp"], s["conv_1x1_exp"],
        what + ".conv_1x1_exp")
    if not mod.avg:
        _prelu(mod.module_act, p["module_act"], what + ".module_act")


def _down(mod: DownSampler, p: Mapping, s: Mapping, what: str) -> None:
    _eesp(mod.eesp, p["eesp"], s["eesp"], what + ".eesp")
    if mod.reinf:
        _cbr(mod.inp_reinf_cbr, p["inp_reinf_cbr"], s["inp_reinf_cbr"],
             what + ".inp_reinf_cbr")
        _cb(mod.inp_reinf_cb, p["inp_reinf_cb"], s["inp_reinf_cb"],
            what + ".inp_reinf_cb")
    _prelu(mod.act, p["act"], what + ".act")


def _pyrpool(mod: EfficientPyrPool, p: Mapping, s: Mapping, what: str) -> None:
    _cbr(mod.proj, p["proj"], s["proj"], what + ".proj")
    dw = np.stack([np.asarray(p[f"dw_s{i}_kernel"])[:, :, 0, :]
                   for i in range(len(mod.scales))])
    _copy(mod.dw_weights, dw, what + ".dw_s*")
    _br(mod.merge_br, p["merge_br"], s["merge_br"], what + ".merge_br")
    _cbr(mod.merge_cbr, p["merge_cbr"], s["merge_cbr"], what + ".merge_cbr")
    _c(mod.classify, p["classify"], what + ".classify")
    if mod.last_br is not None:
        _br(mod.last_br, p["last_br"], s["last_br"], what + ".last_br")


def _pwc(mod: EfficientPWC, p: Mapping, s: Mapping, what: str) -> None:
    _c(mod.wt_conv, p["wt_conv"], what + ".wt_conv")
    _cbr(mod.expand, p["expand"], s["expand"], what + ".expand")


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Fill the port's `ESPNetv2Segmentation` from a flax variable tree of
    nested dicts of numpy arrays, in place; raises on any shape mismatch."""
    p, s = variables["params"], variables["batch_stats"]
    enc, pe, se = model.base_net, p["base_net"], s["base_net"]
    with torch.no_grad():
        _cbr(enc.level1, pe["level1"], se["level1"], "level1")
        for name in ("level2_0", "level3_0", "level4_0"):
            _down(getattr(enc, name), pe[name], se[name], name)
        for stage in ("level3_blocks", "level4_blocks"):
            for i, blk in enumerate(getattr(enc, stage)):
                key = f"{stage}_{i}"
                _eesp(blk, pe[key], se[key], key)
        for name in ("bu_dec_l1", "bu_dec_l2", "bu_dec_l3", "bu_dec_l4"):
            _pyrpool(getattr(model, name), p[name], s[name], name)
        for name in ("merge_l2", "merge_l3", "merge_l4"):
            _pwc(getattr(model, name), p[name], s[name], name)
    model.eval()
