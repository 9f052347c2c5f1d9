"""Pyramid-pool decoder kernels: the CUDA kernels of `csrc/pyrpool.cu` and
their plain PyTorch versions.

* `pyr_branches` replaces mspl_tpu/ops/pallas_pyrpool.py::pyr_branches_pallas
  (the five-scale branch stack of bu_dec_l1..l3, forward only: its backward
  comes with the training slice of the port).
* `pyr_pool_fused_eval` replaces pyr_pool_fused_eval_v3 and its v2/v1
  fallbacks (one contract): the whole eval EfficientPyrPool after the proj
  conv, for the classifier stage bu_dec_l4.

Both take channel-major [B, P, H, W] input, the layout the TPU kernels work
in after their entry transpose, and return [B, S*P, H, W] and [B, O, H, W].
csrc/pyrpool.cu holds the bound and the design note.  The kernels and the
plain versions compute in f32 and round once to the input dtype (the JAX
path rounds bf16 after every resample matmul).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mspl_tpu_torch.ops import _cuda
from mspl_tpu_torch.ops.resize import (adaptive_avg_pool, adaptive_bins,
                                       interp_taps, resize_bilinear)

MAX_P, MAX_S = 16, 8
SMEM_FLOATS = (227 * 1024 - 2048) // 4
TILE = (16, 32)  # the kernels' output tile (csrc/pyrpool.cu TH, TW)
_DTYPES = (torch.float32, torch.bfloat16)
_KIND_ID, _KIND_UP, _KIND_DOWN = 0, 1, 2
_plan_cache: Dict[tuple, tuple] = {}


def branch_sizes(h: int, w: int,
                 scales: Sequence[float]) -> Tuple[Tuple[int, int], ...]:
    return tuple((max(int(math.ceil(h * s)), 5), max(int(math.ceil(w * s)), 5))
                 for s in scales)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + alpha * min(x, 0), alpha per channel of NCHW x."""
    return F.prelu(x, alpha.to(x.dtype))


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Interleave NCHW channels across `groups` (reference `Shuffle`)."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(
        b, c, h, w)


def _dw3x3(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3, zero 'same' padding; taps [3, 3, P]."""
    wk = taps.permute(2, 0, 1).unsqueeze(1).to(x.dtype)  # [P, 1, 3, 3]
    return F.conv2d(x, wk, padding=1, groups=x.shape[1])


def pyr_branches_plain(x: torch.Tensor, weights: torch.Tensor,
                       scales: Sequence[float]) -> torch.Tensor:
    """Plain version of the branch stack: x [B, P, H, W], weights
    [S, 3, 3, P] -> [B, S*P, H, W], computed in f32."""
    xf = x.to(torch.float32)
    wf = weights.to(torch.float32)
    h, w = x.shape[2], x.shape[3]
    branches = []
    for i, (s, hw_s) in enumerate(zip(scales, branch_sizes(h, w, scales))):
        if s < 1.0:
            y = adaptive_avg_pool(xf, hw_s)
        elif s > 1.0:
            y = resize_bilinear(xf, hw_s, align_corners=True)
        else:
            y = xf
        y = _dw3x3(y, wf[i])
        if s != 1.0:
            y = resize_bilinear(y, (h, w), align_corners=True)
        branches.append(y)
    return torch.cat(branches, dim=1).to(x.dtype)


def pyr_pool_fused_eval_plain(x, dw_weights, aff1, merge_weights, aff2,
                              cls_w, cls_b, aff3,
                              scales: Sequence[float]) -> torch.Tensor:
    """Plain version of the fused eval tail, computed in f32.

    x [B, P, H, W]; dw_weights [S, 3, 3, P]; aff1 [3, S*P] (scale, bias,
    PReLU alpha) in concat order si*P + p; merge_weights [3, 3, S, P] (the
    grouped merge after the channel shuffle: group p takes the S branches of
    channel p); aff2 [3, P]; cls_w [P, O]; cls_b [O]; aff3 [3, O].
    Returns [B, O, H, W] in x.dtype."""
    f32 = torch.float32
    aff1, aff2, aff3 = aff1.to(f32), aff2.to(f32), aff3.to(f32)
    s_n, p = len(scales), x.shape[1]
    y = pyr_branches_plain(x.to(f32), dw_weights, scales)
    y = prelu(y * aff1[0].view(1, -1, 1, 1) + aff1[1].view(1, -1, 1, 1),
              aff1[2])
    y = channel_shuffle(y, s_n)
    mw = merge_weights.to(f32).permute(3, 2, 0, 1)  # [P, S, 3, 3]
    y = F.conv2d(y, mw, padding=1, groups=p)
    y = prelu(y * aff2[0].view(1, -1, 1, 1) + aff2[1].view(1, -1, 1, 1),
              aff2[2])
    y = torch.einsum("bphw,po->bohw", y, cls_w.to(f32))
    y = y + cls_b.to(f32).view(1, -1, 1, 1)
    y = prelu(y * aff3[0].view(1, -1, 1, 1) + aff3[1].view(1, -1, 1, 1),
              aff3[2])
    return y.to(x.dtype)


def _extent(back: np.ndarray, n: int, n_s: int, tile: int, halo: int):
    """Largest (R, D) extents along one axis over the kernel's tiles: the
    branch-resolution rows D that the back taps of a tile (and its halo)
    read, and those plus the depthwise halo, R (see csrc/pyrpool.cu)."""
    lo, hi = back[:, 0], back[:, 1]
    if not (np.all(np.diff(lo) >= 0) and np.all(np.diff(hi) >= 0)
            and np.all(lo <= hi)):
        raise ValueError("resample taps are not monotone")
    r_max = d_max = 0
    for t0 in range(0, n, tile):
        o0, o1 = max(t0 - halo, 0), min(t0 + tile - 1 + halo, n - 1)
        d0, d1 = int(lo[o0]), int(hi[o1])
        r0, r1 = max(d0 - 1, 0), min(d1 + 1, n_s - 1)
        r_max, d_max = max(r_max, r1 - r0 + 1), max(d_max, d1 - d0 + 1)
    return r_max, d_max


def _plan(h: int, w: int, scales: Tuple[float, ...], halo: int, device):
    """Per-scale kinds and sizes, the packed (index, weight) resample tables
    on the device, and the shared-memory capacities (floats) of the R and D
    regions for tiles with `halo`; cached per shape."""
    key = (h, w, scales, halo, str(device))
    hit = _plan_cache.get(key)
    if hit is not None:
        return hit
    kinds, idx, wgt = [], [], []
    r_cap = d_cap = 1
    sizes = branch_sizes(h, w, scales)
    for s, (hs, ws) in zip(scales, sizes):
        if s == 1.0:
            kinds.append(_KIND_ID)
            continue
        kinds.append(_KIND_UP if s > 1.0 else _KIND_DOWN)
        to = interp_taps if s > 1.0 else adaptive_bins
        back_h, back_w = interp_taps(hs, h), interp_taps(ws, w)
        for tab in (to(h, hs), to(w, ws), back_h, back_w):
            idx.append(tab[0].reshape(-1))
            wgt.append(tab[1].reshape(-1))
        rh, dh = _extent(back_h[0], h, hs, TILE[0], halo)
        rw, dw = _extent(back_w[0], w, ws, TILE[1], halo)
        r_cap, d_cap = max(r_cap, rh * rw), max(d_cap, dh * dw)
    itab = torch.from_numpy(np.concatenate(idx or [np.zeros(1, np.int32)]))
    ftab = torch.from_numpy(np.concatenate(wgt or [np.zeros(1, np.float32)]))
    hit = (kinds, sizes, itab.to(device), ftab.to(device), r_cap, d_cap)
    _plan_cache[key] = hit
    return hit


def _group(p: int, per_ch: int, budget: int) -> int:
    """Channels a block stages together: as many as `budget` floats of
    shared memory hold when each takes `per_ch`."""
    return max(1, min(p, budget // per_ch))


def _launch(fn, x, weights, scales, halo, out, *extra):
    """Shared argument checks and launch of the two pyramid kernels; `extra`
    goes between the taps and the scratch (the tail's params and O, then
    the channel group size)."""
    _cuda.require(x, "x", _DTYPES)
    b, p, h, w = x.shape
    s_n = len(scales)
    if s_n > MAX_S:
        raise ValueError(f"kernel limit: S <= {MAX_S}")
    weights = weights.to(device=x.device, dtype=torch.float32).contiguous()
    _cuda.require(weights, "weights", (torch.float32,), (s_n, 3, 3, p))
    kinds, sizes, itab, ftab, r_cap, d_cap = _plan(h, w, scales, halo,
                                                   x.device)
    # the down scales' resampled planes (f32), filled by a pre-pass
    scratch = [torch.empty((b * p, hs, ws), dtype=torch.float32,
                           device=x.device) if k == _KIND_DOWN else None
               for k, (hs, ws) in zip(kinds, sizes)]
    ci = ctypes.c_int * s_n
    lib = _lib()
    err = getattr(lib, fn)(
        _cuda.ptr(x), 1 if x.dtype == torch.bfloat16 else 0, b, p, h, w, s_n,
        ci(*kinds), ci(*[hs for hs, _ in sizes]), ci(*[ws for _, ws in sizes]),
        _cuda.ptr(itab), _cuda.ptr(ftab), _cuda.ptr(weights), *extra,
        (ctypes.c_void_p * s_n)(*[None if t is None else t.data_ptr()
                                  for t in scratch]),
        r_cap, d_cap, _cuda.ptr(out), _cuda.stream(x))
    _cuda.check(lib, err, fn)
    return out


def pyr_branches(x: torch.Tensor, weights: torch.Tensor,
                 scales: Sequence[float]) -> torch.Tensor:
    """Five-scale branch stack: x [B, P, H, W], weights [S, 3, 3, P] ->
    [B, S*P, H, W] (channel si*P + c) in x.dtype.  CPU tensors take the
    plain version; CUDA tensors launch the kernels."""
    if not x.is_cuda:
        return pyr_branches_plain(x, weights, scales)
    b, p, h, w = x.shape
    out = torch.empty((b, len(scales) * p, h, w), dtype=x.dtype,
                      device=x.device)
    _, _, _, _, r_cap, d_cap = _plan(h, w, tuple(scales), 0, x.device)
    # half a block's shared memory: the kernel's registers let two blocks
    # share an SM, which beats staging more channels at once
    g = _group(p, 9 + TILE[0] * TILE[1] + r_cap + d_cap, SMEM_FLOATS // 2)
    _launch("pyr_branches_launch", x, weights, tuple(scales), 0, out, g)
    pyr_branches.launches += 1
    return out


pyr_branches.launches = 0


def pyr_pool_fused_eval(x, dw_weights, aff1, merge_weights, aff2, cls_w,
                        cls_b, aff3, scales: Sequence[float]) -> torch.Tensor:
    """Whole eval EfficientPyrPool after the proj conv (see the plain
    version for the argument layouts) -> channel-major [B, O, H, W] in
    x.dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernels."""
    if not x.is_cuda:
        return pyr_pool_fused_eval_plain(x, dw_weights, aff1, merge_weights,
                                         aff2, cls_w, cls_b, aff3, scales)
    b, p, h, w = x.shape
    s_n, o = len(scales), cls_w.shape[1]
    if p > MAX_P:
        raise ValueError(f"kernel limit: P <= {MAX_P}")
    f32 = torch.float32
    for name, t, shape in (("aff1", aff1, (3, s_n * p)),
                           ("merge_weights", merge_weights, (3, 3, s_n, p)),
                           ("aff2", aff2, (3, p)), ("cls_w", cls_w, (p, o)),
                           ("cls_b", cls_b, (o,)), ("aff3", aff3, (3, o))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    params = torch.cat([t.to(device=x.device, dtype=f32).reshape(-1)
                        for t in (aff1, merge_weights, aff2, cls_w, cls_b,
                                  aff3)])
    out = torch.empty((b, o, h, w), dtype=x.dtype, device=x.device)
    _, _, _, _, r_cap, d_cap = _plan(h, w, tuple(scales), 1, x.device)
    # all of a block's shared memory: the kernel's registers allow one
    # block an SM
    g = _group(p, 9 + (TILE[0] + 2) * (TILE[1] + 2) + r_cap + d_cap,
               SMEM_FLOATS - params.numel())
    _launch("pyr_tail_launch", x, dw_weights, tuple(scales), 1, out,
            _cuda.ptr(params), o, g)
    pyr_pool_fused_eval.launches += 1
    return out


pyr_pool_fused_eval.launches = 0


def _lib():
    lib = _cuda.load("pyrpool")
    if lib.pyr_branches_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        head = [vp] + [ci] * 6 + [vp] * 6  # x, dtype..s_n, kinds..taps
        tail = [vp, ci, ci, vp, vp]        # scratch, r_cap, d_cap, out, stream
        lib.pyr_branches_launch.argtypes = head + [ci] + tail  # g
        lib.pyr_tail_launch.argtypes = head + [vp, ci, ci] + tail  # params, O, g
        lib.pyr_branches_launch.restype = ci
        lib.pyr_tail_launch.restype = ci
    return lib
