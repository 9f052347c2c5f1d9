"""Channel-major bilinear upsample of the logits: the CUDA kernel
`csrc/resize_x2.cu` and its plain PyTorch version.

Replaces mspl_tpu/ops/pallas_resize.py::resize_x2_cm_pallas, the final x2
resize (align_corners=True) of the classifier stage's [B, C, H/2, W/2]
logits.  Bound on the card: bytes.  The kernel gathers four taps per output
pixel from the interpolation matrix's (index, weight) form and accumulates
in f32; unlike the TPU kernel it does not round the H pass to bf16 before
the W pass.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from mspl_tpu_torch.ops import _cuda
from mspl_tpu_torch.ops.resize import interp_taps, resize_bilinear

_DTYPES = (torch.float32, torch.bfloat16)
_taps_cache: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def resize_x2_cm_plain(x: torch.Tensor, size_hw: Tuple[int, int],
                       align_corners: bool = True) -> torch.Tensor:
    """Plain version: the matrix resize in f32, one rounding to x.dtype."""
    return resize_bilinear(x.to(torch.float32), size_hw,
                           align_corners).to(x.dtype)


def device_taps(in_size: int, out_size: int, device) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """`interp_taps(in, out)` as (int32, f32) tensors on `device`, cached."""
    key = (in_size, out_size, str(device))
    hit = _taps_cache.get(key)
    if hit is None:
        idx, wgt = interp_taps(in_size, out_size)
        hit = (torch.from_numpy(np.ascontiguousarray(idx)).to(device),
               torch.from_numpy(np.ascontiguousarray(wgt)).to(device))
        _taps_cache[key] = hit
    return hit


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
    hidx, hwgt = device_taps(hi, ho, x.device)
    widx, wwgt = device_taps(wi, wo, x.device)
    lib = _lib()
    err = lib.resize_bilinear_launch(
        _cuda.ptr(x), _cuda.ptr(out), 1 if x.dtype == torch.bfloat16 else 0,
        b * c, hi, wi, ho, wo, _cuda.ptr(hidx), _cuda.ptr(hwgt),
        _cuda.ptr(widx), _cuda.ptr(wwgt), _cuda.stream(x))
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
                       vp, vp, vp, vp, vp]
        fn.restype = ci
    return lib
