"""EESP branch stacks: the CUDA kernel of `csrc/eesp_branches.cu` and its
plain PyTorch versions.

* `eesp_branches` replaces mspl_tpu/ops/pallas_eesp.py::eesp_branches_pallas:
  the K dilated depthwise 3x3 branches (padding = dilation) of a stride-1
  EESP unit with the hierarchical feature fusion (cumulative adds) and the
  concat, channel ki*n + c.
* `down_front` replaces mspl_tpu/ops/pallas_downsampler.py::down_front_pallas:
  the same stack at stride 2 (output (H-1)//2+1) beside the 3x3/s2 average
  pool of the block input (count_include_pad=True).  Nothing routes to it:
  the JAX package switches its kernel off (mspl_tpu/layers/eesp.py:111).

Layouts are NCHW; the weights keep the JAX layout [K, 3, 3, n].  The kernel
and the plain versions accumulate the taps and the HFF sums in f32 and round
each output once to the input dtype (the TPU kernel of the stride-1 stack
multiplies in the input dtype).  csrc/eesp_branches.cu holds the bound and
the design note.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from mspl_tpu_torch.ops import _cuda

MAX_K = 8
_DTYPES = (torch.float32, torch.bfloat16)


def _stack_plain(proj: torch.Tensor, weights: torch.Tensor,
                 dilations: Sequence[int], stride: int) -> torch.Tensor:
    xf = proj.to(torch.float32)
    n = proj.shape[1]
    wf = weights.to(device=proj.device, dtype=torch.float32)
    acc, outs = None, []
    for ki, d in enumerate(dilations):
        wk = wf[ki].permute(2, 0, 1).unsqueeze(1)  # [n, 1, 3, 3]
        y = F.conv2d(xf, wk, stride=stride, padding=d, dilation=d, groups=n)
        acc = y if acc is None else acc + y
        outs.append(acc)
    return torch.cat(outs, dim=1).to(proj.dtype)


def eesp_branches_plain(proj: torch.Tensor, weights: torch.Tensor,
                        dilations: Sequence[int]) -> torch.Tensor:
    """Plain version: proj [B, n, H, W], weights [K, 3, 3, n] ->
    [B, K*n, H, W], computed in f32, rounded once to proj.dtype."""
    return _stack_plain(proj, weights, dilations, 1)


def down_front_plain(x: torch.Tensor, proj: torch.Tensor,
                     weights: torch.Tensor, dilations: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x [B, nin, H, W], proj [B, n, H, W], weights
    [K, 3, 3, n] -> (pool [B, nin, H2, W2], branches [B, K*n, H2, W2])."""
    pool = F.avg_pool2d(x.to(torch.float32), 3, stride=2, padding=1,
                        count_include_pad=True).to(x.dtype)
    return pool, _stack_plain(proj, weights, dilations, 2)


def _launch(proj, x, weights, dilations, stride):
    _cuda.require(proj, "proj", _DTYPES)
    b, n, h, w = proj.shape
    k = len(dilations)
    if not 1 <= k <= MAX_K or min(dilations) < 1:
        raise ValueError(f"kernel limit: 1..{MAX_K} branches, dilations >= 1")
    taps = weights.to(device=proj.device, dtype=torch.float32).contiguous()
    _cuda.require(taps, "weights", (torch.float32,), (k, 3, 3, n))
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = torch.empty((b, k * n, ho, wo), dtype=proj.dtype, device=proj.device)
    pool, nin = None, 0
    if x is not None:
        _cuda.require(x, "x", (proj.dtype,))
        nin = x.shape[1]
        if (x.shape[0], x.shape[2], x.shape[3]) != (b, h, w):
            raise ValueError(f"x {tuple(x.shape)} does not match proj "
                             f"{tuple(proj.shape)}")
        pool = torch.empty((b, nin, ho, wo), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.eesp_branches_launch(
        _cuda.ptr(proj), None if x is None else _cuda.ptr(x), _cuda.ptr(out),
        None if pool is None else _cuda.ptr(pool), _cuda.ptr(taps),
        1 if proj.dtype == torch.bfloat16 else 0, stride, b, n, nin, h, w, k,
        (ctypes.c_int * k)(*[int(d) for d in dilations]), _cuda.stream(proj))
    _cuda.check(lib, err, "eesp_branches_launch")
    return out, pool


def eesp_branches(proj: torch.Tensor, weights: torch.Tensor,
                  dilations: Sequence[int]) -> torch.Tensor:
    """Stride-1 EESP branch stack + HFF: proj [B, n, H, W], weights
    [K, 3, 3, n] -> [B, K*n, H, W] in proj.dtype.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if not proj.is_cuda:
        return eesp_branches_plain(proj, weights, dilations)
    out, _ = _launch(proj, None, weights, dilations, 1)
    eesp_branches.launches += 1
    return out


eesp_branches.launches = 0


def down_front(x: torch.Tensor, proj: torch.Tensor, weights: torch.Tensor,
               dilations: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """DownSampler front: (AvgPool 3x3/s2/pad 1 of x, stride-2 branch stack
    + HFF of proj); see the plain version for the shapes.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (one launch for
    both outputs)."""
    if not proj.is_cuda:
        return down_front_plain(x, proj, weights, dilations)
    out, pool = _launch(proj, x, weights, dilations, 2)
    down_front.launches += 1
    return pool, out


down_front.launches = 0


def _lib():
    lib = _cuda.load("eesp_branches")
    fn = lib.eesp_branches_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ci] * 8 + [ctypes.POINTER(ci), vp]
        fn.restype = ci
    return lib
