"""Channel-major bilinear upsample of the logits: the CUDA kernel
`csrc/resize_x2.cu` and its plain PyTorch version.

Replaces mspl_tpu/ops/pallas_resize.py::resize_x2_cm_pallas, the final x2
resize (align_corners=True) of the classifier stage's [B, C, H/2, W/2]
logits.  Bound on the card: bytes.  A block stages the input rows of a band
of output rows in shared memory; each thread forms 8 consecutive outputs
from the interpolation matrix's (index, weight) form and stores them at
once.  It accumulates in f32; unlike the TPU kernel it does not round the H
pass to bf16 before the W pass.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from mspl_tpu_torch.ops import _cuda
from mspl_tpu_torch.ops.resize import interp_taps, resize_bilinear

_DTYPES = (torch.float32, torch.bfloat16)
_taps_cache: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
MAX_ROWS = 32  # output rows a block takes at most (csrc RS_MAX_ROWS)
SMEM_BYTES = 227 * 1024


def resize_x2_cm_plain(x: torch.Tensor, size_hw: Tuple[int, int],
                       align_corners: bool = True) -> torch.Tensor:
    """Plain version: the matrix resize in f32, one rounding to x.dtype."""
    return resize_bilinear(x.to(torch.float32), size_hw,
                           align_corners).to(x.dtype)


def device_taps(in_size: int, out_size: int, device,
                chunked: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """`interp_taps(in, out)` (or its `chunk_taps` layout) as (int32, f32)
    tensors on `device`, cached."""
    key = (in_size, out_size, str(device), chunked)
    hit = _taps_cache.get(key)
    if hit is None:
        idx, wgt = (chunk_taps if chunked else interp_taps)(in_size, out_size)
        hit = (torch.from_numpy(np.ascontiguousarray(idx)).to(device),
               torch.from_numpy(np.ascontiguousarray(wgt)).to(device))
        _taps_cache[key] = hit
    return hit


def chunk_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """`interp_taps(in, out)` in the kernel's chunk-major layout: idx int32
    and wgt f32 [2, 8, ceil(out / 8)], entry [t, j, c] = tap t of output
    column 8c + j (index 0, weight 0 past the end)."""
    idx, wgt = interp_taps(in_size, out_size)
    chunks = -(-out_size // 8)
    ci = np.zeros((chunks * 8, 2), np.int32)
    cw = np.zeros((chunks * 8, 2), np.float32)
    ci[:out_size], cw[:out_size] = idx, wgt
    return (np.ascontiguousarray(ci.reshape(chunks, 8, 2).transpose(2, 1, 0)),
            np.ascontiguousarray(cw.reshape(chunks, 8, 2).transpose(2, 1, 0)))


@lru_cache(maxsize=None)
def row_bands(hi: int, ho: int, wi: int, esize: int) -> Tuple[int, int]:
    """(rows a block, staged input elements): the most output rows, up to
    MAX_ROWS, whose input rows fit a block's shared memory beside the row
    taps, and the most input elements any band of them stages.  Raises if
    not even one output row's input fits."""
    lo, hi_idx = interp_taps(hi, ho)[0].T
    room = SMEM_BYTES - 16 * MAX_ROWS - 16
    for rb in range(MAX_ROWS, 0, -1):
        starts = np.arange(0, ho, rb)
        ends = np.minimum(starts + rb, ho) - 1
        cap = int((hi_idx[ends] - lo[starts] + 1).max()) * wi
        if cap * esize <= room:
            return rb, cap
    raise ValueError(f"kernel limit: two rows of a {wi}-wide input exceed "
                     "a block's shared memory")


def resize_x2_cm(x: torch.Tensor, size_hw: Tuple[int, int],
                 align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of channel-major [B, C, H, W] to size_hw = (H', W').
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not align_corners:
        raise ValueError("the logits resize is align_corners=True only")
    if x.dim() != 4:
        raise ValueError(f"expected BCHW input, got {tuple(x.shape)}")
    if not x.is_cuda:
        return resize_x2_cm_plain(x, size_hw, align_corners)
    _cuda.require(x, "x", _DTYPES)
    b, c, hi, wi = x.shape
    ho, wo = size_hw
    out = torch.empty((b, c, ho, wo), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    hidx, hwgt = device_taps(hi, ho, x.device)
    widx, wwgt = device_taps(wi, wo, x.device, chunked=True)
    esize = x.element_size()
    rb, in_cap = row_bands(hi, ho, wi, esize)
    vec_in = wi * esize % 16 == 0 and x.data_ptr() % 16 == 0
    vec_out = wo * esize % 16 == 0 and out.data_ptr() % 16 == 0
    lib = _lib()
    err = lib.resize_bilinear_launch(
        _cuda.ptr(x), _cuda.ptr(out), 1 if x.dtype == torch.bfloat16 else 0,
        b * c, hi, wi, ho, wo, rb, in_cap, int(vec_in), int(vec_out),
        _cuda.ptr(hidx), _cuda.ptr(hwgt), _cuda.ptr(widx), _cuda.ptr(wwgt),
        _cuda.stream(x))
    _cuda.check(lib, err, "resize_bilinear_launch")
    resize_x2_cm.launches += 1
    return out


resize_x2_cm.launches = 0


def _lib():
    lib = _cuda.load("resize_x2")
    fn = lib.resize_bilinear_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ctypes.c_longlong, ci, ci, ci, ci,
                       ci, ci, ci, ci, vp, vp, vp, vp, vp]
        fn.restype = ci
    return lib
