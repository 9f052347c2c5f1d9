"""Bilinear resize and adaptive average pooling on NCHW tensors (port of
mspl_tpu/ops/resize.py).

Both are built from the same numpy operator matrices as the JAX path
(`_interp_matrix`, `_adaptive_avg_matrix`, copied verbatim), applied along H
and W with einsum in the tensor's dtype: bf16 operands accumulate in f32 in
the matmul and round once per pass, as the JAX `_mm` convention does.  The
index/weight form of the same operators (`interp_taps`, `adaptive_bins`)
feeds the CUDA kernels, which gather instead of multiplying by mostly-zero
matrices.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense [out_size, in_size] linear-interpolation matrix."""
    o = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = o * ((in_size - 1) / (out_size - 1)) if out_size > 1 else np.zeros_like(o)
    else:
        src = (o + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    mat[np.arange(out_size), lo] += 1.0 - w_hi
    mat[np.arange(out_size), hi] += w_hi
    return mat.astype(np.float32)


@lru_cache(maxsize=None)
def _adaptive_avg_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] matrix implementing torch adaptive_avg_pool1d bin semantics:
    bin i averages input [floor(i*I/O), ceil((i+1)*I/O))."""
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        lo = (o * in_size) // out_size
        hi = -((-(o + 1) * in_size) // out_size)  # ceil
        mat[o, lo:hi] = 1.0 / (hi - lo)
    return mat.astype(np.float32)


@lru_cache(maxsize=None)
def interp_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Two-tap form of `_interp_matrix(in, out, align_corners=True)`:
    (idx int32 [out, 2] = (lo, hi), wgt float32 [out, 2]), read off the
    matrix itself so the kernels use the very same weights."""
    mat = _interp_matrix(in_size, out_size, True)
    idx = np.zeros((out_size, 2), np.int32)
    wgt = np.zeros((out_size, 2), np.float32)
    for o in range(out_size):
        nz = np.nonzero(mat[o])[0]
        lo = int(nz[0]) if nz.size else 0
        hi = int(nz[-1]) if nz.size else 0
        idx[o] = (lo, hi)
        wgt[o] = (mat[o, lo], mat[o, hi] if hi != lo else 0.0)
    return idx, wgt


@lru_cache(maxsize=None)
def adaptive_bins(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Bin form of `_adaptive_avg_matrix`: (idx int32 [out, 2] = [lo, hi)
    input range, wgt float32 [out, 2] = (1/(hi-lo), 0))."""
    mat = _adaptive_avg_matrix(in_size, out_size)
    idx = np.zeros((out_size, 2), np.int32)
    wgt = np.zeros((out_size, 2), np.float32)
    for o in range(out_size):
        nz = np.nonzero(mat[o])[0]
        idx[o] = (nz[0], nz[-1] + 1)
        wgt[o, 0] = mat[o, nz[0]]
    return idx, wgt


@lru_cache(maxsize=None)
def _device_matrix(build, args: tuple, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    # one upload per operator and device: a host-to-device copy from
    # pageable memory waits for the stream, which would stall the forward.
    # Made outside inference mode whatever the caller's mode: an eval
    # forward may fill the cache and a train step's backward then saves it
    with torch.inference_mode(False):
        return torch.from_numpy(build(*args)).to(device=device, dtype=dtype)


def _mm(eq: str, build, args: tuple, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, _device_matrix(build, args, x.device, x.dtype), x)


def resize_bilinear(x: torch.Tensor, size_hw: Tuple[int, int],
                    align_corners: bool = True,
                    order: str = "hw") -> torch.Tensor:
    """Bilinearly resize NCHW `x` to spatial `size_hw` = (H, W); `order`
    picks which contraction runs first ("hw" or "wh"), as in JAX."""
    if order not in ("hw", "wh"):
        raise ValueError(f"order must be 'hw' or 'wh', got {order!r}")
    if x.dim() != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    h_in, w_in = x.shape[2], x.shape[3]
    h_out, w_out = size_hw
    for dim in (("h", "w") if order == "hw" else ("w", "h")):
        if dim == "h" and h_in != h_out:
            x = _mm("oh,bchw->bcow", _interp_matrix,
                    (h_in, h_out, align_corners), x)
        elif dim == "w" and w_in != w_out:
            x = _mm("ow,bchw->bcho", _interp_matrix,
                    (w_in, w_out, align_corners), x)
    return x


def adaptive_avg_pool(x: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """torch ``F.adaptive_avg_pool2d`` on NCHW input, as two small matmuls
    (the JAX path's formulation, so both sum in the same order)."""
    if x.dim() != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    h_in, w_in = x.shape[2], x.shape[3]
    h_out, w_out = size_hw
    if h_in != h_out:
        x = _mm("oh,bchw->bcow", _adaptive_avg_matrix, (h_in, h_out), x)
    if w_in != w_out:
        x = _mm("ow,bchw->bcho", _adaptive_avg_matrix, (w_in, w_out), x)
    return x
