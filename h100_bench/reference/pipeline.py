"""The plain reference of what the timed paths compute around the models:
normalization, the label conversion into the greenhouse space, soft
fusion with its confidence and per-class thresholds, the CBST histograms,
kc and re-threshold (Zou et al., CBST, arXiv:1810.07911), the train-time
scale / crop / flip with its draws, the segmentation loss with class
weights and the KLD regularizer (CRST, arXiv:1908.09822), the poly
schedule and SGD with momentum and weight decay.

Written from the MSPL recipe (Matsuzaki et al., arXiv:2102.06386); the
class orders and their mapping to plant / artificial object / ground are
the data sets' published ones.  Imports nothing of the port.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference.layers import PLAIN

IGNORE = 255
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
_P, _A, _G, _I = 0, 1, 2, IGNORE
# source class order -> greenhouse class (plant 0, artificial object 1,
# ground 2, ignore 255)
TO_GREENHOUSE = {
    # sky, building, pole, road, sidewalk, tree, sign, fence, car,
    # pedestrian, bicyclist
    "camvid": (_I, _A, _A, _G, _G, _P, _A, _A, _A, _I, _I),
    # road, sidewalk, building, wall, fence, pole, light, sign, vegetation,
    # terrain, sky, person, rider, car, truck, bus, train, motorcycle,
    # bicycle
    "cityscapes": (_G, _G, _A, _A, _A, _A, _A, _A, _P, _G, _I, _I, _I, _A,
                   _A, _A, _A, _A, _A),
    # road, grass, vegetation, sky, obstacle
    "forest": (_G, _G, _P, _I, _A),
    "greenhouse": (_P, _A, _G),
}


def conversion(dataset: str, num_target: int = 3) -> np.ndarray:
    """[C_src, T + 1] 0/1 table; the last column takes the ignored mass."""
    lut = TO_GREENHOUSE[dataset]
    mat = np.zeros((len(lut), num_target + 1), np.float32)
    for s, t in enumerate(lut):
        mat[s, num_target if t == IGNORE else t] = 1.0
    return mat


MODELS_DIR = Path(__file__).resolve().parent / "models"


def model_module(name: str) -> ModuleType:
    """The reference model file `models/<name>.py` of a configuration's
    `model` name: `MODEL`, its class; `weight_law(leaf, shape)`, each
    leaf's law (`weights.py`); `DENSE_OPS`, the FLOP counter's op families
    that the whole step's share counts."""
    path = MODELS_DIR / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise ValueError(f"no reference model '{name}': {path} is missing")
    return importlib.import_module(f"h100_bench.reference.models.{name}")


def build_model(spec: Dict, num_classes: int, dtype: torch.dtype,
                num=PLAIN) -> torch.nn.Module:
    """The reference model of a configuration's `model` entry: the name
    and the constructor's keywords, every one passed on (a key that the
    reference does not take raises)."""
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in spec.items() if k != "name"}
    return model_module(spec["name"]).MODEL(num_classes, compute_dtype=dtype,
                                            num=num, **kw)


def normalize(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> f32 [B, 3, H, W] with ImageNet statistics."""
    x = img_u8.to(torch.float32) / 255.0
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


# --- pseudo-labels ---

def soft_fusion(logits: Sequence[torch.Tensor], tables: Sequence[np.ndarray],
                kc=None):
    """Mean over the models of each softmax pooled into the target space;
    label = argmax over the T target columns, conf = its value; a pixel
    whose conf is below kc[label] is ignored.  Returns (label int64, conf
    f32, fused [B, T+1, H, W] f32)."""
    acc = None
    for x, tab in zip(logits, tables):
        p = torch.softmax(x.float(), dim=1)
        q = torch.einsum("bchw,ct->bthw", p, torch.from_numpy(tab).to(
            x.device))
        acc = q if acc is None else acc + q
    fused = acc / len(logits)
    t = fused.shape[1] - 1
    conf = fused[:, :t].amax(dim=1)
    label = fused[:, :t].argmax(dim=1)  # the first of tied classes
    if kc is not None:
        label = apply_kc(label, conf, kc)
    return label, conf, fused


def apply_kc(label: torch.Tensor, conf: torch.Tensor, kc) -> torch.Tensor:
    kc = torch.as_tensor(np.asarray(kc, np.float32), device=conf.device)
    safe = torch.where(label == IGNORE, 0, label).long().clamp(
        0, kc.numel() - 1)
    return torch.where(conf >= kc[safe], label,
                       torch.full_like(label, IGNORE))


def histograms(label: torch.Tensor, conf: torch.Tensor, num_classes: int,
               bins: int = 1024) -> torch.Tensor:
    """[T, bins] counts of each class's confidences, bin int(conf * bins)."""
    lab = label.reshape(-1).long()
    b = (conf.reshape(-1).float() * bins).long().clamp(0, bins - 1)
    keep = lab != IGNORE
    counts = torch.bincount(lab[keep] * bins + b[keep],
                            minlength=num_classes * bins)
    return counts.reshape(num_classes, bins).double()


def kc_from_histograms(hist: torch.Tensor, p: float,
                       max_kc: float = 0.999) -> np.ndarray:
    """kc[c]: the lower edge of the highest bin at which the count from
    the top reaches p of class c's pixels (0 for an empty class)."""
    h = hist.cpu().numpy().astype(np.float64)
    t, bins = h.shape
    kc = np.zeros(t)
    if p >= 1.0:
        return kc.astype(np.float32)
    for c in range(t):
        total = h[c].sum()
        if total == 0:
            continue
        from_top = np.cumsum(h[c][::-1])[::-1]
        meets = np.nonzero(from_top >= p * total)[0]
        kc[c] = (meets[-1] if meets.size else 0) / bins
    return np.minimum(kc, max_kc).astype(np.float32)


# --- training ---

def class_weights(label_hist: np.ndarray, norm: float = 1.02) -> np.ndarray:
    """1 / ln(norm + frequency) of each class."""
    h = np.asarray(label_hist, np.float64)
    return (1.0 / np.log(norm + h / max(h.sum(), 1.0))).astype(np.float32)


def step_draws(seed: int, step: int, n: int, in_hw, crop_hw, scale_range):
    """Per image (s, y0, x0, flip) of global step `step`: four uniform f32
    draws an image from a CPU generator seeded seed * 2**32 + step."""
    g = torch.Generator().manual_seed(seed * 2 ** 32 + step)
    u = torch.rand((n, 4), generator=g, dtype=torch.float32)
    lo, hi = scale_range
    s = u[:, 0] * (hi - lo) + lo
    y0 = u[:, 1] * (in_hw[0] - crop_hw[0] / s).clamp_min(0.0)
    x0 = u[:, 2] * (in_hw[1] - crop_hw[1] / s).clamp_min(0.0)
    return s, y0, x0, u[:, 3] < 0.5


def _axis_weights(n_in, n_out, scale, translation):
    """[B, n_in, n_out] triangle-kernel weights, renormalized by their
    column sums and zero where the sample falls outside the image."""
    dev = scale.device
    inv = 1.0 / scale
    o = torch.arange(n_out, dtype=torch.float32, device=dev)
    sample = ((o[None] + 0.5) * inv[:, None] - (translation * inv)[:, None]
              - 0.5)
    i = torch.arange(n_in, dtype=torch.float32, device=dev)
    w = (1.0 - (sample[:, None, :] - i[None, :, None]).abs()).clamp_min(0.0)
    tot = w.sum(dim=1, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def scale_crop_flip(imgs, labels, crop_hw, s, y0, x0, flip):
    """Resample each image through its window (bilinear) and take its
    labels by the nearest pixel (outside the image: ignore), then flip."""
    b, _, h, w = imgs.shape
    ch, cw = crop_hw
    dev = imgs.device
    s, y0, x0 = (v.to(dev, torch.float32) for v in (s, y0, x0))
    flip = flip.to(dev)
    wy = _axis_weights(h, ch, s, -(y0 * s))
    wx = _axis_weights(w, cw, s, -(x0 * s))
    wx = torch.where(flip[:, None, None], wx.flip(-1), wx)
    out = torch.einsum("bhy,bchw,bwx->bcyx", wy, imgs.float(), wx)
    yi = torch.floor((torch.arange(ch, dtype=torch.float32, device=dev)
                      + 0.5) / s[:, None] + y0[:, None]).long()
    xi = torch.floor((torch.arange(cw, dtype=torch.float32, device=dev)
                      + 0.5) / s[:, None] + x0[:, None]).long()
    xi = torch.where(flip[:, None], xi.flip(-1), xi)
    oob = (((yi < 0) | (yi >= h))[:, :, None]
           | ((xi < 0) | (xi >= w))[:, None, :])
    bi = torch.arange(b, device=dev)[:, None, None]
    lab = labels.to(dev)[bi, yi.clamp(0, h - 1)[:, :, None],
                         xi.clamp(0, w - 1)[:, None, :]]
    return out, torch.where(oob, torch.full_like(lab, IGNORE), lab)


def loss_fn(logits, labels, cw, reg_weight):
    """Class-weighted mean cross-entropy over the labelled pixels plus
    reg_weight times the mean KLD(p || uniform) term over them."""
    c = logits.shape[1]
    logp = F.log_softmax(logits.float(), dim=1)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    nll = -logp.gather(1, safe[:, None])[:, 0]
    wts = torch.where(valid, cw[safe], 0.0)
    mask = valid.float()
    loss = (nll * wts).sum() / wts.sum().clamp_min(1e-8)
    reg = -logp.mean(dim=1) / c
    return loss + reg_weight * (reg * mask).sum() / mask.sum().clamp_min(
        1e-8)


def poly_lr(base: float, total: int, step: int, power: float = 0.9):
    frac = 1.0 - min(max(step, 0), total) / total
    return base * frac ** power


def sgd_step(params, grads, bufs, lr, momentum, weight_decay):
    """torch-style SGD: d = g + wd * p; buf = d (first step) or
    momentum * buf + d; p -= lr * buf.  Returns the new buffers."""
    out = []
    with torch.no_grad():
        for p, g, b in zip(params, grads, bufs):
            d = g + weight_decay * p
            b = d.clone() if b is None else b.mul(momentum).add(d)
            p.sub_(lr * b)
            out.append(b)
    return out
