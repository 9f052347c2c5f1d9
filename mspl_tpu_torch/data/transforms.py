"""Device-side image transforms (port of mspl_tpu/data/transforms.py):
`normalize`, and the train-time fused RandomScale + RandomCrop +
RandomFlip.

As in the reference, scale and crop are one resampling step: a scale s is
drawn, a crop window of crop / s source pixels is placed at (y0, x0), and
the window is resampled straight to the crop size, the way
`jax.image.scale_and_translate(method="linear", antialias=False)` does it
(per axis a weight matrix of the triangle kernel, renormalized by its
column sums and zeroed where the sample falls outside the image, so that a
window larger than the image leaves zeros), as the separable product
out = Wy^T . img . Wx of each image.  Labels take the nearest pixel through
the same window (outside the image: ignore), then both flip.  The draws
(s, y0, x0, flip) are made per image from an explicit torch.Generator
(`draw_scale_crop_flip`), and `scale_crop_flip` is the deterministic rest,
which the tests hold against the reference at the reference's own draws.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from mspl_tpu_torch.utils.registry import (IGNORE_LABEL, IMAGENET_MEAN,
                                           IMAGENET_STD)


def normalize(
    img: torch.Tensor,
    mean: Tuple[float, float, float] = IMAGENET_MEAN,
    std: Tuple[float, float, float] = IMAGENET_STD,
) -> torch.Tensor:
    """uint8/float [B,H,W,C] image in [0,255] -> normalized float32
    [B,C,H,W], on the tensor's own device.

    The arithmetic runs in NHWC exactly as the JAX version does, then the
    batch is permuted to NCHW once.  Channels beyond len(mean) (the RGB-D
    depth channel) are normalized with mean 0.5 / std 0.5."""
    x = img.to(torch.float32) / 255.0
    c = x.shape[-1]
    mean_t = _stats(tuple(mean) + (0.5,) * max(0, c - len(mean)), x.device)
    std_t = _stats(tuple(std) + (0.5,) * max(0, c - len(std)), x.device)
    x = (x - mean_t) / std_t
    return x.permute(0, 3, 1, 2).contiguous()


@lru_cache(maxsize=None)
def _stats(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    # made once per device: a host-to-device copy from pageable memory
    # waits for the stream, which would stall every batch; outside
    # inference mode, as train steps share it with the eval forwards
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)


def _linear_weights(n_in: int, n_out: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """[B, n_in, n_out] resampling weights of one axis per image, as
    jax.image's `compute_weight_mat` with the triangle kernel and no
    antialiasing: output o samples the input at (o + 0.5) / s - t / s -
    0.5 (f32, the reference's order of operations)."""
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


def scale_crop_flip(imgs: torch.Tensor, labels: torch.Tensor,
                    crop_hw: Tuple[int, int], scale: torch.Tensor,
                    y0: torch.Tensor, x0: torch.Tensor, flip: torch.Tensor,
                    ignore_label: int = IGNORE_LABEL
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic core of the fused scale / crop / flip.

    imgs float [B, C, H, W], labels integer [B, H, W]; per image the scale
    s, the window origin (y0, x0) in source pixels (f32) and the flip
    (bool), each [B] on any device.  Returns (float32 [B, C, ch, cw],
    labels [B, ch, cw] in the labels' dtype), on the images' device."""
    b, _, h, w = imgs.shape
    ch, cw = crop_hw
    dev = imgs.device
    s, y0, x0 = (torch.as_tensor(v, dtype=torch.float32).to(dev)
                 for v in (scale, y0, x0))
    flip = torch.as_tensor(flip, dtype=torch.bool).to(dev)
    # the reference's translation: -origin * s
    wy = _linear_weights(h, ch, s, -(y0 * s))
    wx = _linear_weights(w, cw, s, -(x0 * s))
    # a flip reverses the output columns, so it reverses Wx's columns
    wx = torch.where(flip[:, None, None], wx.flip(-1), wx)
    out = torch.einsum("bhy,bchw,bwx->bcyx", wy, imgs.to(torch.float32), wx)

    yi = torch.floor((torch.arange(ch, dtype=torch.float32, device=dev)
                      + 0.5) / s[:, None] + y0[:, None]).to(torch.int64)
    xi = torch.floor((torch.arange(cw, dtype=torch.float32, device=dev)
                      + 0.5) / s[:, None] + x0[:, None]).to(torch.int64)
    xi = torch.where(flip[:, None], xi.flip(-1), xi)
    oob = (((yi < 0) | (yi >= h))[:, :, None]
           | ((xi < 0) | (xi >= w))[:, None, :])
    bi = torch.arange(b, device=dev)[:, None, None]
    lab = labels.to(dev)[bi, yi.clamp(0, h - 1)[:, :, None],
                         xi.clamp(0, w - 1)[:, None, :]]
    lab = torch.where(oob, torch.full_like(lab, ignore_label), lab)
    return out, lab


def draw_scale_crop_flip(n: int, in_hw: Tuple[int, int],
                         crop_hw: Tuple[int, int],
                         generator: torch.Generator,
                         scale_range: Tuple[float, float] = (0.5, 2.0)):
    """Per image, as the reference draws them: s uniform in scale_range,
    the window crop / s placed uniformly inside the image (at 0 where it is
    larger), a flip with probability 1/2.  Four f32 draws an image from
    `generator` (a CPU generator gives the same draws for every device).
    Returns (s, y0, x0, flip), each [n] on the CPU."""
    u = torch.rand((n, 4), generator=generator, dtype=torch.float32)
    lo, hi = scale_range
    s = u[:, 0] * (hi - lo) + lo
    y0 = u[:, 1] * (in_hw[0] - crop_hw[0] / s).clamp_min(0.0)
    x0 = u[:, 2] * (in_hw[1] - crop_hw[1] / s).clamp_min(0.0)
    return s, y0, x0, u[:, 3] < 0.5


def train_transform(imgs: torch.Tensor, labels: torch.Tensor,
                    crop_hw: Tuple[int, int], generator: torch.Generator,
                    scale_range: Tuple[float, float] = (0.5, 2.0),
                    mean: Tuple[float, float, float] = IMAGENET_MEAN,
                    std: Tuple[float, float, float] = IMAGENET_STD
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched train-time pipeline on the images' device: normalize, then
    the fused scale / crop / flip at draws from `generator`.  imgs uint8
    [B, H, W, C], labels [B, H, W] -> (float32 [B, C, ch, cw], labels
    [B, ch, cw])."""
    draws = draw_scale_crop_flip(imgs.shape[0], tuple(imgs.shape[1:3]),
                                 crop_hw, generator, scale_range)
    return scale_crop_flip(normalize(imgs, mean, std), labels, crop_hw,
                           *draws)
