"""Fused pseudo-label pass over channel-major logits: the CUDA kernel
`csrc/pseudo_cm.cuh` and its plain PyTorch version.

Replaces mspl_tpu/ops/pallas_pseudo_cm.py::fused_pseudo_cm (and its entry
point fused_pseudo_soft_cm).  Per pixel over N logit stacks [B, C_m, H, W]:
softmax, conversion through the [C_m, T+1] tables, soft or hard fusion,
argmax and confidence, then `conf >= kc[label]` else ignore.  With
`kc=None` the threshold is 0 for every class, the JAX kernel's convention
(an entropy confidence that rounds below 0 is set to ignore).

Bound on the card: bytes (every logit read once, 8 bytes written per
pixel); see the source note in csrc/pseudo_cm.cuh for the design and
`launch_plan` for what the wrapper decides per call.  The kernel is built
as two libraries: `pseudo_cm.cu` holds the single-dtype instances (all
models f32 or all bf16), `pseudo_cm_mixed.cu` the instances that read
each model in its own dtype.

Kernel limits, which the reference does not have (the plain version has
none; on the card the wrapper raises): at most MAX_MODELS = 4 models,
MAX_C = 32 source classes a model and MAX_T1 - 1 = 7 target classes; the
pixel-major pass ⑧ (`ops/pseudo.py`) shares them.  A self-training round's
ensemble, the three sources plus the target model, fills the 4 models
exactly, so whoever picks the sources (the self-training slice, the CLI)
must keep to them.  The pyramid-pool tail ② (`ops/pyrpool.py`) takes
P <= 16 and S <= 8.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mspl_tpu_torch.ops import _cuda
from mspl_tpu_torch.utils.registry import IGNORE_LABEL

MAX_MODELS, MAX_C, MAX_T1 = 4, 32, 8
PIXELS_PER_THREAD = 4  # csrc/pseudo_cm.cuh VP: one 8- or 16-byte load
_DTYPES = (torch.float32, torch.bfloat16)


def launch_plan(channels: Sequence[int], n_t: int, hw: int,
                aligned: bool) -> Tuple[Tuple[int, ...], int, bool]:
    """What the kernel is launched with: each model's register width (its
    channel count rounded up to a multiple of 4), the tables' padded width
    (4 or 8 columns, the template instance that holds T+1), and whether a
    thread reads its 4 pixels with one vector load a channel (the plane's
    pixel count a multiple of 4 and every tensor on a 16-byte word; else
    element by element)."""
    widths = tuple(-(-c // 4) * 4 for c in channels)
    t1 = 4 if n_t + 1 <= 4 else MAX_T1
    return widths, t1, aligned and hw % PIXELS_PER_THREAD == 0


def bf16_mask(logits: Sequence[torch.Tensor]) -> int:
    """The kernels' per-model dtype word: bit m set where model m's
    logits are bf16 (else f32)."""
    return sum(1 << m for m, x in enumerate(logits)
               if x.dtype == torch.bfloat16)


def _check_args(logits_cm, conversions, mode, conf_mode):
    if not logits_cm or len(logits_cm) != len(conversions):
        raise ValueError("need N>=1 matching logits/conversion pairs")
    if mode not in ("soft", "hard"):
        raise ValueError(f"unknown fusion mode '{mode}'")
    if conf_mode not in ("prob", "entropy"):
        raise ValueError(f"unknown conf_mode '{conf_mode}'")
    convs = [np.asarray(c, np.float32) for c in conversions]
    n_t = int(convs[0].shape[1]) - 1
    b, _, h, w = logits_cm[0].shape
    for x, c in zip(logits_cm, convs):
        if x.dim() != 4 or (x.shape[0], x.shape[2], x.shape[3]) != (b, h, w):
            raise ValueError(f"logits {tuple(x.shape)} do not match "
                             f"[{b}, C, {h}, {w}]")
        if c.shape != (x.shape[1], n_t + 1):
            raise ValueError(f"conversion {c.shape} != ({x.shape[1]}, "
                             f"{n_t + 1})")
    return convs, n_t


def _kc_vector(kc, n_t: int, device) -> torch.Tensor:
    if kc is None:
        return torch.zeros(n_t, dtype=torch.float32, device=device)
    kc = torch.as_tensor(kc, dtype=torch.float32, device=device)
    return torch.broadcast_to(kc, (n_t,)).contiguous()


def fused_pseudo_cm_plain(
    logits_cm: Sequence[torch.Tensor],
    conversions: Sequence[np.ndarray],
    kc: Optional[torch.Tensor],
    mode: str = "soft",
    min_agree: Optional[int] = None,
    ignore_label: int = IGNORE_LABEL,
    conf_mode: str = "prob",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, same arithmetic order:
    q_t = (sum_c exp(x_c - max) * table[c, t]) * (1 / sum_c exp(...))."""
    convs, n_t = _check_args(logits_cm, conversions, mode, conf_mode)
    n = len(convs)
    dev = logits_cm[0].device
    kc_t = _kc_vector(kc, n_t, dev)
    need = min_agree if min_agree is not None else (n // 2 + 1)
    inv_n = 1.0 / n

    def xlogx(p):
        return torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-30)),
                           torch.zeros_like(p))

    acc = None
    for x, conv in zip(logits_cm, convs):
        x = x.to(torch.float32)
        e = torch.exp(x - x.amax(dim=1, keepdim=True))
        inv = 1.0 / e.sum(dim=1)
        tab = torch.from_numpy(conv).to(dev)
        q = torch.einsum("bchw,ct->bthw", e, tab) * inv[:, None]
        if mode == "hard":
            lab_m = torch.argmax(q, dim=1)  # == T: the ignore column
            q = (lab_m[:, None] == torch.arange(n_t, device=dev)[
                None, :, None, None]).to(torch.float32)
        else:
            q = q[:, :n_t]
        acc = q if acc is None else acc + q

    if mode == "hard":
        top = acc.amax(dim=1)
        lbl = torch.argmax(acc, dim=1)
        if conf_mode == "entropy":
            s = xlogx((n - acc.sum(dim=1)) * inv_n)
            s = s + xlogx(acc * inv_n).sum(dim=1)
            conf = 1.0 + s * (1.0 / math.log(n_t + 1))
        else:
            conf = top * inv_n
        lbl = torch.where(top >= need, lbl, torch.full_like(lbl, ignore_label))
    else:
        fused = acc * inv_n
        conf = fused.amax(dim=1)
        lbl = torch.argmax(fused, dim=1)
        if conf_mode == "entropy":
            p_ig = torch.clamp(1.0 - fused.sum(dim=1), min=0.0)
            s = xlogx(p_ig) + xlogx(fused).sum(dim=1)
            conf = 1.0 + s * (1.0 / math.log(n_t + 1))
    valid = (lbl >= 0) & (lbl < n_t)
    thr = torch.where(valid, kc_t[lbl.clamp(0, n_t - 1)],
                      torch.zeros_like(conf))
    lbl = torch.where(conf >= thr, lbl, torch.full_like(lbl, ignore_label))
    return lbl.to(torch.int32), conf


def _tables(convs: Sequence[np.ndarray], device) -> torch.Tensor:
    """The tables concatenated in model order, on `device`; uploaded once
    per set of tables (a copy from pageable memory waits for the stream)."""
    flat = np.concatenate([c.reshape(-1) for c in convs]).astype(np.float32)
    key = (flat.tobytes(), str(device))
    hit = _tables_cache.get(key)
    if hit is None:
        hit = _tables_cache[key] = torch.from_numpy(flat).to(device)
    return hit


_tables_cache: Dict[tuple, torch.Tensor] = {}


def fused_pseudo_cm(
    logits_cm: Sequence[torch.Tensor],
    conversions: Sequence[np.ndarray],
    kc: Optional[torch.Tensor],
    mode: str = "soft",
    min_agree: Optional[int] = None,
    ignore_label: int = IGNORE_LABEL,
    conf_mode: str = "prob",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused pseudo-label pass (soft or hard) on channel-major logits.

    logits_cm: N tensors [B, C_m, H, W], each f32 or bf16 on its own (a
    self-training round's ensemble mixes bf16 sources with an f32 target
    model; each is read in its own dtype, as by the JAX kernel);
    conversions: N numpy [C_m, T+1] tables; kc: [T] thresholds or None.
    Returns (label int32 [B,H,W], conf f32 [B,H,W]).  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if not logits_cm[0].is_cuda:
        return fused_pseudo_cm_plain(logits_cm, conversions, kc, mode,
                                     min_agree, ignore_label, conf_mode)
    convs, n_t = _check_args(logits_cm, conversions, mode, conf_mode)
    n = len(convs)
    if n > MAX_MODELS or n_t + 1 > MAX_T1 or max(
            c.shape[0] for c in convs) > MAX_C:
        raise ValueError(f"kernel limits: <= {MAX_MODELS} models, <= {MAX_C} "
                         f"source classes, <= {MAX_T1 - 1} target classes")
    x0 = logits_cm[0]
    for i, x in enumerate(logits_cm):
        _cuda.require(x, f"logits[{i}]", _DTYPES)
        if x.device != x0.device:
            raise ValueError("all logits must lie on one device")
    b, _, h, w = x0.shape
    dev = x0.device
    label = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    conf = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    tables = _tables(convs, dev)
    kc_t = _kc_vector(kc, n_t, dev)
    need = min_agree if min_agree is not None else (n // 2 + 1)
    if b > 65535:
        raise ValueError("kernel limit: batch <= 65535")
    cs = [int(c.shape[0]) for c in convs]
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (*logits_cm, label, conf))
    widths, t1, vec = launch_plan(cs, n_t, h * w, aligned)
    pad = [0] * (MAX_MODELS - n)
    ptrs = [_cuda.ptr(x) for x in logits_cm] + [None] * len(pad)
    mask = bf16_mask(logits_cm)
    lib, launch = _lib(mixed=0 < mask < (1 << n) - 1)
    err = launch(
        *ptrs, *(cs + pad), *(list(widths) + pad), n, _cuda.ptr(tables),
        _cuda.ptr(kc_t), n_t, h * w, b, mask, int(mode == "hard"),
        int(conf_mode == "entropy"), float(need), ignore_label,
        1.0 / math.log(n_t + 1), t1, int(vec), _cuda.ptr(label),
        _cuda.ptr(conf), _cuda.stream(x0))
    _cuda.check(lib, err, launch.__name__)
    fused_pseudo_cm.launches += 1
    return label, conf


fused_pseudo_cm.launches = 0


def _lib(mixed: bool):
    """(library, launch entry) of the single-dtype kernels, or of the mixed
    ones (`csrc/pseudo_cm_mixed.cu`: the instances that read f32 and bf16
    models in one launch)."""
    name = "pseudo_cm_mixed" if mixed else "pseudo_cm"
    lib = _cuda.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # logits, channels, widths, N, tables, kc, T, H*W, B, bf16 mask, hard,
        # entropy, min_agree, ignore, 1/ln(T+1), T1 instance, vec, label,
        # conf, stream
        fn.argtypes = ([vp] * 4 + [ci] * 9 + [vp, vp, ci, ctypes.c_longlong,
                                               ci, ci, ci, ci,
                                               ctypes.c_float, ci,
                                               ctypes.c_float, ci, ci, vp,
                                               vp, vp])
        fn.restype = ci
    return lib, fn
