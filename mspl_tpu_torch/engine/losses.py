"""Segmentation losses (port of mspl_tpu/engine/losses.py): cross-entropy
with ignore 255 and optional per-class weights, plus the CRST confidence
regularizers on pseudo-labelled pixels.

The port's logits are channel-major [B, C, H, W], so the class axis is 1
(the JAX loss with `channel_axis=1`).  Everything is computed in f32
whatever the logits' dtype (in f64 for f64 logits), and masked rather than indexed, so the loss
keeps one shape for every batch.

Under a mesh (`parallel/mesh.py`) each rank holds a slice of the global
batch and passes its data axis's process group: the loss is then a mean
over the global batch's valid pixels, as the JAX package's is under a
mesh, not the mean of the slices' means.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mspl_tpu_torch.utils.registry import IGNORE_LABEL


def compute_class_weights(label_histogram: np.ndarray,
                          norm_const: float = 1.02) -> np.ndarray:
    """Inverse-log-frequency class weights: w_c = 1 / ln(norm + freq_c)
    (the ESPNet/ENet weighting)."""
    hist = np.asarray(label_histogram, np.float64)
    freq = hist / np.maximum(hist.sum(), 1.0)
    return (1.0 / np.log(norm_const + freq)).astype(np.float32)


def segmentation_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    ignore_label: int = IGNORE_LABEL,
    reg_mode: str = "none",  # 'none' | 'kld' | 'ent'  (CRST MRKLD / MRENT)
    reg_weight: float = 0.0,
    batch_mask: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Weighted mean cross-entropy over the pixels whose label is not
    `ignore_label` (and whose batch row `batch_mask` [B] keeps), plus
    `reg_weight` times the mean regularizer over those pixels.

    logits [B, C, H, W] (any float dtype), labels [B, H, W] integers.
    With `group`, the process group over whose ranks the global batch is
    split: the means' denominators (from the labels and class weights
    alone, so without gradient) are summed over it first, one
    `all_reduce`, and the loss returned is this rank's numerators over
    the global denominators, its share of the global loss; the shares
    sum to it."""
    c = logits.shape[1]
    f = torch.promote_types(logits.dtype, torch.float32)
    logp = F.log_softmax(logits.to(f), dim=1)
    valid = labels != ignore_label
    if batch_mask is not None:
        valid = valid & batch_mask.to(torch.bool)[:, None, None]
    safe = torch.where(valid, labels, 0).to(torch.int64)
    pixel_loss = -logp.gather(1, safe[:, None])[:, 0]
    if class_weights is None:
        wts = valid.to(f)
    else:
        cw = torch.as_tensor(class_weights, dtype=f,
                             device=logits.device)
        wts = torch.where(valid, cw[safe], 0.0)
    mask = valid.to(f)
    den = torch.stack([wts.sum(), mask.sum()]).detach()
    if group is not None:
        dist.all_reduce(den, group=group)
    den = den.clamp_min(1e-8)
    loss = (pixel_loss * wts).sum() / den[0]

    if reg_mode != "none" and reg_weight > 0.0:
        if reg_mode == "kld":
            # KLD(p || uniform) up to a constant: -mean(log p) / C
            reg = -logp.mean(dim=1) / c
        elif reg_mode == "ent":
            reg = (logp.exp() * logp).sum(dim=1) / c  # negative entropy
        else:
            raise ValueError(f"unknown reg_mode '{reg_mode}'")
        loss = loss + reg_weight * ((reg * mask).sum() / den[1])
    return loss
