"""Class-balanced thresholds (CBST; port of mspl_tpu/pseudo/cbst.py).

kc[c] is the confidence at the top-p quantile of class c's pixel
confidences.  The per-class populations are accumulated on the device as
fixed-size confidence histograms (1024 bins over [0, 1]) and the quantile
is taken on the small [T, bins] array on the host.

The JAX package builds its histogram as a two-level one-hot contraction
because scatter-add is serial on the TPU; on the GPU it is one
`torch.bincount`.  Each public function runs in a span `mspl.cbst.<name>`
(`utils/profiling.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from mspl_tpu_torch.utils.profiling import span
from mspl_tpu_torch.utils.registry import IGNORE_LABEL

DEFAULT_BINS = 1024


def class_confidence_histograms(
    label: torch.Tensor,
    conf: torch.Tensor,
    num_classes: int,
    num_bins: int = DEFAULT_BINS,
    ignore_label: int = IGNORE_LABEL,
) -> torch.Tensor:
    """Per-class histogram of confidences in [0, 1]: label int [...], conf
    float [...] -> float32 [num_classes, num_bins] of exact integer counts,
    on label's device.  Ignored pixels contribute nothing; a confidence is
    binned as int(conf * num_bins) (truncation) clipped to the bin range."""
    with span("mspl.cbst.histograms"):
        lab = label.reshape(-1).to(torch.int64)
        b = (conf.reshape(-1).to(torch.float32) * num_bins).to(torch.int64)
        b = b.clamp(0, num_bins - 1)
        valid = lab != ignore_label
        flat = lab[valid] * num_bins + b[valid]
        hist = torch.bincount(flat, minlength=num_classes * num_bins)
        return hist.to(torch.float32).reshape(num_classes, num_bins)


def kc_from_histograms(hist, p: float, max_kc: float = 0.999) -> np.ndarray:
    """kc[c] = confidence at the top-p quantile of class c's population.

    hist: [T, bins] counts (numpy or tensor).  p >= 1 keeps everything
    (kc = 0); empty classes get kc = 0; kc is capped at `max_kc` so a
    saturated class never rejects all of its pixels."""
    with span("mspl.cbst.kc"):
        if isinstance(hist, torch.Tensor):
            hist = hist.detach().cpu().numpy()
        hist = np.asarray(hist, np.float64)
        t, bins = hist.shape
        totals = hist.sum(axis=1)
        if p >= 1.0:
            return np.zeros(t, np.float32)
        # cumulative counts from the top confidence bin downwards
        cum_from_top = np.cumsum(hist[:, ::-1], axis=1)[:, ::-1]
        target = p * totals
        meets = cum_from_top >= target[:, None]
        # the highest bin whose top-cumulative count still meets the target
        idx = np.where(meets.any(axis=1),
                       bins - 1 - np.argmax(meets[:, ::-1], axis=1), 0)
        kc = idx.astype(np.float64) / bins  # lower edge of the bin
        kc = np.where(totals > 0, kc, 0.0)
        return np.minimum(kc, max_kc).astype(np.float32)


def _apply_kc_set(labels: torch.Tensor, confs: torch.Tensor,
                  kc: torch.Tensor, ignore_label: int) -> torch.Tensor:
    """The CBST keep rule on tensors of one device: pixels with
    conf < kc[label] become `ignore_label`, in the labels' dtype.  A label
    outside [0, len(kc)) other than `ignore_label` reads the nearest kc, as
    the reference's clamped gather does."""
    safe = torch.where(labels == ignore_label, 0, labels).to(torch.int64)
    thr = kc[safe.clamp(0, kc.numel() - 1)]
    return torch.where(confs >= thr, labels,
                       torch.full_like(labels, ignore_label))


def apply_kc_device(labels, confs, kc, ignore_label: int = IGNORE_LABEL
                    ) -> torch.Tensor:
    """Re-threshold a whole label/confidence set with per-class kc: one
    compare and select on the labels' device (`_apply_kc_set`); the output
    keeps the labels' dtype (uint8 from the on-device generation path)."""
    with span("mspl.cbst.apply_kc"):
        labels = torch.as_tensor(labels)
        confs = torch.as_tensor(confs).to(labels.device)
        kc_t = torch.as_tensor(np.asarray(kc, np.float32),
                               device=labels.device)
        return _apply_kc_set(labels, confs, kc_t, ignore_label)


def sweep_kc(labels, confs, num_classes: int, p: float,
             num_bins: int = DEFAULT_BINS) -> np.ndarray:
    """Histogram a full label/confidence set on its device and return kc
    (numpy float32 [num_classes])."""
    with span("mspl.cbst.sweep_kc"):
        hist = class_confidence_histograms(torch.as_tensor(labels),
                                           torch.as_tensor(confs),
                                           num_classes, num_bins)
        return kc_from_histograms(hist, p)
