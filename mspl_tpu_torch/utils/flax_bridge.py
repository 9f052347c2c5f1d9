"""Load a flax variable tree of the JAX package into the port's modules.

`load_flax_variables(model, variables)` takes the `{"params",
"batch_stats"}` tree of `mspl_tpu.models.ESPNetv2Segmentation` or
`DeepLabV3` as nested dicts of numpy arrays (the caller converts JAX arrays
with `np.asarray`; this package never imports JAX) and copies every leaf
into the matching parameter or buffer of the port's model of that type,
in place.

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

DeepLab's leaves carry flax's auto-names in call order: a conv's kernel
sits under `_Conv_i/Conv_0` (explicit names for `stem`, `downsample`,
`project`, `low_proj`, `fuse`; the classifier is a bare `Conv` with a
bias), a BatchNorm's under `_BN_i/BatchNorm_0`.  So a bottleneck's
`downsample` BN is `_BN_3`; in the ASPP `_Conv_4`/`_BN_4` is the image
pool and `_BN_5` the projection's; at the top level `_BN_0` is
`low_proj`'s and `_BN_1` `fuse`'s.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mspl_tpu_torch.layers.conv_blocks import BR, C, CB, CBR, BatchNorm, PReLU
from mspl_tpu_torch.layers.eesp import EESP, DownSampler
from mspl_tpu_torch.layers.pyramid_pool import EfficientPWC, EfficientPyrPool
from mspl_tpu_torch.models.deeplab import ASPP, Bottleneck, DeepLabV3


def _copy(dst: torch.Tensor, src, what: str) -> None:
    t = torch.from_numpy(np.asarray(src, np.float32))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: flax shape {tuple(t.shape)} != port shape "
                         f"{tuple(dst.shape)}")
    dst.copy_(t)


def _hwio(dst: torch.Tensor, kernel, what: str) -> None:
    _copy(dst, np.transpose(np.asarray(kernel), (3, 2, 0, 1)), what)


def _conv(conv: torch.nn.Conv2d, leaf: Mapping, what: str) -> None:
    _hwio(conv.weight, leaf["kernel"], what)
    if conv.bias is not None:
        _copy(conv.bias, leaf["bias"], what + ".bias")


def _c(mod: C, p: Mapping, what: str) -> None:
    _conv(mod.conv, p["Conv_0"], what)


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


def _dl_bn(mod: BatchNorm, p: Mapping, s: Mapping, key: str,
           what: str) -> None:
    _bn(mod, p[key]["BatchNorm_0"], s[key]["BatchNorm_0"], what)


def _bottleneck(mod: Bottleneck, p: Mapping, s: Mapping, what: str) -> None:
    for i, (conv, bn) in enumerate(((mod.conv1, mod.bn1),
                                    (mod.conv2, mod.bn2),
                                    (mod.conv3, mod.bn3))):
        _conv(conv, p[f"_Conv_{i}"]["Conv_0"], f"{what}.conv{i + 1}")
        _dl_bn(bn, p, s, f"_BN_{i}", f"{what}.bn{i + 1}")
    if mod.downsample is not None:
        _conv(mod.downsample[0], p["downsample"]["Conv_0"],
              what + ".downsample")
        _dl_bn(mod.downsample[1], p, s, "_BN_3", what + ".downsample_bn")


def _aspp(mod: ASPP, p: Mapping, s: Mapping, what: str) -> None:
    convs = [mod.b0, *mod.bs, mod.gp]
    bns = [mod.bn0, *mod.bns, mod.gp_bn]
    for i, (conv, bn) in enumerate(zip(convs, bns)):
        _conv(conv, p[f"_Conv_{i}"]["Conv_0"], f"{what}._Conv_{i}")
        _dl_bn(bn, p, s, f"_BN_{i}", f"{what}._BN_{i}")
    _conv(mod.project, p["project"]["Conv_0"], what + ".project")
    _dl_bn(mod.project_bn, p, s, f"_BN_{len(bns)}", what + ".project_bn")


def _deeplab(model: DeepLabV3, p: Mapping, s: Mapping) -> None:
    enc, pe, se = model.encoder, p["encoder"], s["encoder"]
    _conv(enc.stem, pe["stem"]["Conv_0"], "encoder.stem")
    _dl_bn(enc.stem_bn, pe, se, "_BN_0", "encoder.stem_bn")
    for si, stage in enumerate(enc.stages):
        for bi, blk in enumerate(stage):
            key = f"stage{si}_{bi}"
            _bottleneck(blk, pe[key], se[key], f"encoder.{key}")
    _aspp(model.aspp, p["aspp"], s["aspp"], "aspp")
    _conv(model.low_proj, p["low_proj"]["Conv_0"], "low_proj")
    _dl_bn(model.low_bn, p, s, "_BN_0", "low_bn")
    _conv(model.fuse, p["fuse"]["Conv_0"], "fuse")
    _dl_bn(model.fuse_bn, p, s, "_BN_1", "fuse_bn")
    _conv(model.classifier, p["classifier"], "classifier")


def _espnetv2(model: torch.nn.Module, p: Mapping, s: Mapping) -> None:
    enc, pe, se = model.base_net, p["base_net"], s["base_net"]
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


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Fill the port's `ESPNetv2Segmentation` or `DeepLabV3` from a flax
    variable tree of nested dicts of numpy arrays, in place; raises on any
    shape mismatch."""
    load = _deeplab if isinstance(model, DeepLabV3) else _espnetv2
    with torch.no_grad():
        load(model, variables["params"], variables["batch_stats"])
    model.eval()
