"""Fused pseudo-label pass over pixel-major (NHWC) logits: the CUDA kernel
`csrc/pseudo_pm.cu` and its plain PyTorch version.

Replaces mspl_tpu/ops/pallas_pseudo.py::fused_pseudo_pass_pallas, the form
of the fused pass for sources that hand the engine NHWC logits; its plain
version is the reference pass `fused_pseudo_pass_plain` (the JAX package's
`generate.fused_pseudo_pass`, re-exported under that name by
`pseudo/generate.py`).  Per pixel over N logit tensors [B, H, W, C_m]:
softmax, conversion through the [C_m, T+1] tables, soft or hard fusion,
argmax and confidence, and with kc the per-class threshold.  Unlike the
channel-major pass (ops/pseudo_cm.py), kc=None thresholds nothing.

Bound on the card: bytes (every logit read once, 8 bytes written per
pixel); see the source note in csrc/pseudo_pm.cu for the design.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mspl_tpu_torch.ops import _cuda
from mspl_tpu_torch.ops.pseudo_cm import (MAX_C, MAX_MODELS, MAX_T1,
                                          _tables, bf16_mask)
from mspl_tpu_torch.utils.registry import IGNORE_LABEL

_DTYPES = (torch.float32, torch.bfloat16)


def convert_probs(probs: torch.Tensor, conversion) -> torch.Tensor:
    """Pool source-space probabilities [..., C] into the target space."""
    mat = torch.as_tensor(np.asarray(conversion), dtype=probs.dtype,
                          device=probs.device)
    return torch.einsum("...s,st->...t", probs, mat)


def entropy_confidence(dist: torch.Tensor) -> torch.Tensor:
    """1 - H(dist) / ln(K) over the last axis (normalized anti-entropy)."""
    d = dist.to(torch.float32)
    xlogx = torch.where(d > 0, d * torch.log(torch.clamp(d, min=1e-30)),
                        torch.zeros_like(d))
    return 1.0 - (-xlogx.sum(dim=-1)) / float(np.log(dist.shape[-1]))


def _apply_kc(label, conf, kc, t, ignore_label):
    if kc is None:
        return label, conf
    kc_t = torch.broadcast_to(
        torch.as_tensor(kc, dtype=torch.float32, device=conf.device), (t,))
    safe = torch.where(label == ignore_label, 0, label)
    ignore = torch.full_like(label, ignore_label)
    return torch.where(conf >= kc_t[safe], label, ignore), conf


def fused_pseudo_pass_plain(
    logits_list: Sequence[torch.Tensor],
    conversions: Sequence[np.ndarray],
    mode: str = "soft",
    kc=None,
    num_target: Optional[int] = None,
    min_agree: Optional[int] = None,
    ignore_label: int = IGNORE_LABEL,
    conf_mode: str = "prob",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse N NHWC logit tensors [B,H,W,C_m] into (label int32 [B,H,W],
    conf f32 [B,H,W]); the plain reference of the fused pass.

    soft: mean of the converted probability maps, conf = its max over the
    T target classes (entropy: 1 - H/ln(T+1) of the full T+1 map).  hard:
    one-hot votes of each model's converted argmax (the ignore column votes
    for nothing), label = vote argmax, ignore below `min_agree` (default a
    strict majority), conf = agreeing fraction (entropy: of the vote
    distribution with abstentions as ignore votes).  kc=None does not
    threshold at all (the channel-major kernel thresholds against 0)."""
    if len(logits_list) != len(conversions) or not logits_list:
        raise ValueError("need N>=1 matching logits/conversion pairs")
    if conf_mode not in ("prob", "entropy"):
        raise ValueError(f"unknown conf_mode '{conf_mode}'")
    n_models = len(logits_list)
    t = int(np.asarray(conversions[0]).shape[1]) - 1
    if num_target is not None and num_target != t:
        raise ValueError(f"conversion target dim {t} != num_target {num_target}")

    if mode == "soft":
        acc = None
        for logits, mat in zip(logits_list, conversions):
            q = convert_probs(torch.softmax(logits.to(torch.float32), -1), mat)
            acc = q if acc is None else acc + q
        fused = acc / n_models
        label = torch.argmax(fused[..., :t], dim=-1).to(torch.int32)
        conf = (entropy_confidence(fused) if conf_mode == "entropy"
                else fused[..., :t].amax(dim=-1))
    elif mode == "hard":
        votes = None
        for logits, mat in zip(logits_list, conversions):
            q = convert_probs(torch.softmax(logits.to(torch.float32), -1), mat)
            lab_m = torch.argmax(q, dim=-1)  # may be t, the ignore column
            onehot = (lab_m[..., None] == torch.arange(
                t, device=q.device)).to(torch.float32)
            votes = onehot if votes is None else votes + onehot
        label = torch.argmax(votes, dim=-1).to(torch.int32)
        top = votes.amax(dim=-1)
        need = min_agree if min_agree is not None else (n_models // 2 + 1)
        if conf_mode == "entropy":
            ig = n_models - votes.sum(dim=-1, keepdim=True)
            conf = entropy_confidence(torch.cat([votes, ig], -1) / n_models)
        else:
            conf = top / n_models
        label = torch.where(top >= need, label,
                            torch.full_like(label, ignore_label))
    else:
        raise ValueError(f"unknown fusion mode '{mode}'")
    return _apply_kc(label, conf, kc, t, ignore_label)


def fused_pseudo_pass_pm(
    logits_list: Sequence[torch.Tensor],
    conversions: Sequence[np.ndarray],
    mode: str = "soft",
    kc=None,
    min_agree: Optional[int] = None,
    ignore_label: int = IGNORE_LABEL,
    conf_mode: str = "prob",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused pseudo-label pass (soft or hard) on contiguous NHWC logits.

    logits_list: N tensors [B, H, W, C_m], each f32 or bf16 on its own
    (read in its own dtype, as by the JAX kernel);
    conversions: N numpy [C_m, T+1] tables; kc: [T] thresholds or None.
    Returns (label int32 [B,H,W], conf f32 [B,H,W]).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if not logits_list or not logits_list[0].is_cuda:
        return fused_pseudo_pass_plain(
            logits_list, conversions, mode=mode, kc=kc, min_agree=min_agree,
            ignore_label=ignore_label, conf_mode=conf_mode)
    if len(logits_list) != len(conversions):
        raise ValueError("need N>=1 matching logits/conversion pairs")
    if mode not in ("soft", "hard"):
        raise ValueError(f"unknown fusion mode '{mode}'")
    if conf_mode not in ("prob", "entropy"):
        raise ValueError(f"unknown conf_mode '{conf_mode}'")
    convs = [np.asarray(c, np.float32) for c in conversions]
    n, n_t = len(convs), int(convs[0].shape[1]) - 1
    x0 = logits_list[0]
    shape = tuple(x0.shape[:3])
    for i, (x, c) in enumerate(zip(logits_list, convs)):
        _cuda.require(x, f"logits[{i}]", _DTYPES)
        if (x.dim() != 4 or tuple(x.shape[:3]) != shape
                or x.device != x0.device):
            raise ValueError(f"logits {tuple(x.shape)} do not match "
                             f"{list(shape) + ['C']} on one device")
        if c.shape != (x.shape[3], n_t + 1):
            raise ValueError(f"conversion {c.shape} != ({x.shape[3]}, "
                             f"{n_t + 1})")
    if n > MAX_MODELS or n_t + 1 > MAX_T1 or max(
            c.shape[0] for c in convs) > MAX_C:
        raise ValueError(f"kernel limits: <= {MAX_MODELS} models, <= {MAX_C} "
                         f"source classes, <= {MAX_T1 - 1} target classes")
    dev = x0.device
    label = torch.empty(shape, dtype=torch.int32, device=dev)
    conf = torch.empty(shape, dtype=torch.float32, device=dev)
    tables = _tables(convs, dev)
    kc_t = (None if kc is None else torch.broadcast_to(torch.as_tensor(
        kc, dtype=torch.float32, device=dev), (n_t,)).contiguous())
    need = min_agree if min_agree is not None else (n // 2 + 1)
    ptrs = [_cuda.ptr(x) for x in logits_list] + [None] * (MAX_MODELS - n)
    cs = [int(c.shape[0]) for c in convs] + [0] * (MAX_MODELS - n)
    lib = _lib()
    err = lib.pseudo_pm_launch(
        *ptrs, *cs, n, _cuda.ptr(tables),
        None if kc_t is None else _cuda.ptr(kc_t), int(kc_t is not None), n_t,
        label.numel(), bf16_mask(logits_list),
        int(mode == "hard"), int(conf_mode == "entropy"), int(need),
        ignore_label, 1.0 / math.log(n_t + 1), _cuda.ptr(label),
        _cuda.ptr(conf), _cuda.stream(x0))
    _cuda.check(lib, err, "pseudo_pm_launch")
    fused_pseudo_pass_pm.launches += 1
    return label, conf


fused_pseudo_pass_pm.launches = 0


def _lib():
    lib = _cuda.load("pseudo_pm")
    fn = lib.pseudo_pm_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 4 + [ci] * 5 + [vp, vp, ci, ci,
                                               ctypes.c_longlong, ci, ci, ci,
                                               ci, ci, ctypes.c_float, vp, vp,
                                               vp])
        fn.restype = ci
    return lib
