"""EESP branch stacks: the CUDA kernels of `csrc/eesp_branches.cu` and their
plain PyTorch versions.

* `eesp_branches` replaces mspl_tpu/ops/pallas_eesp.py::eesp_branches_pallas:
  the K dilated depthwise 3x3 branches (padding = dilation) of a stride-1
  EESP unit with the hierarchical feature fusion (cumulative adds) and the
  concat, channel ki*n + c.  Its kernel takes whole planes a block and
  8-output column runs a thread (`stack_plan` says how many planes, and
  the source note in csrc/eesp_branches.cu why).
* `down_front` replaces mspl_tpu/ops/pallas_downsampler.py::down_front_pallas:
  the same stack at stride 2 (output (H-1)//2+1) beside the 3x3/s2 average
  pool of the block input (count_include_pad=True).  Nothing routes to it:
  the JAX package switches its kernel off (mspl_tpu/layers/eesp.py:111).

Layouts are NCHW.  `eesp_branches` takes its taps packed by `pack_taps`
as [n, K*9] f32 (the `use_pallas` route caches that per unit);
`down_front` keeps the JAX layout [K, 3, 3, n].  The kernels and the plain
versions accumulate the taps and the HFF sums in f32 and round each output
once to the input dtype (the TPU kernel of the stride-1 stack multiplies in
the input dtype).  csrc/eesp_branches.cu holds the bound and the design
notes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from mspl_tpu_torch.ops import _cuda

MAX_K = 8
_DTYPES = (torch.float32, torch.bfloat16)
# csrc/eesp_branches.cu: ST_NT threads a block, ST_RUN outputs a thread
THREADS, RUN = 128, 8
# the dilation schedules with template instances (sched 0 and 1); any
# other takes the run-time-dilation instance (sched 2)
SCHEDULES = ((1, 2, 3, 4), (1, 1, 2, 3))
SMEM_CAP = 48 * 1024  # shared bytes a block the plan stays within


def pack_taps(weights: torch.Tensor) -> torch.Tensor:
    """[K, 3, 3, n] taps -> the kernel's [n, K*9] f32 (channel c's 9*K taps
    contiguous, tap k*9 + ky*3 + kx)."""
    k, _, _, n = weights.shape
    return weights.detach().reshape(k * 9, n).t().to(torch.float32).contiguous()


class StackPlan(NamedTuple):
    """How the stride-1 kernel covers a call: the instance (`sched`), planes
    a block (`pb`), output rows a band (`bh`, the plane's height unless a
    plane exceeds SMEM_CAP) and bands a plane, a plane's shared layout
    (`rows` of `sw` floats, image column x at `lpad + x`), the block's
    shared bytes, whether it stages with 16-byte loads, and the outputs a
    thread computes a run (RUN down a column, K branches)."""
    sched: int
    pb: int
    bh: int
    nbands: int
    lpad: int
    sw: int
    rows: int
    smem: int
    vec: bool
    outputs_per_run: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def stack_plan(b: int, n: int, h: int, w: int, dilations: Sequence[int],
               itemsize: int, aligned: bool) -> StackPlan:
    """The launch plan of `eesp_branches` at proj [b, n, h, w] of
    `itemsize`-byte elements; `aligned`: proj sits on a 16-byte word."""
    k, dmax = len(dilations), max(dilations)
    dil = tuple(int(d) for d in dilations)
    sched = SCHEDULES.index(dil) if dil in SCHEDULES else len(SCHEDULES)
    lpad = _ceil(dmax, 4) * 4
    sw = _ceil(lpad + w + dmax, 4) * 4

    def smem(pb: int, bh: int) -> int:
        rows = _ceil(bh, RUN) * RUN + 2 * dmax
        return 4 * (_ceil(pb * k * 9, 4) * 4 + pb * rows * sw)

    bh = h
    if smem(1, h) > SMEM_CAP:
        fit = (SMEM_CAP // 4 - _ceil(k * 9, 4) * 4) // sw - 2 * dmax
        bh = fit // RUN * RUN
        if bh < RUN:
            raise ValueError(f"kernel limit: a plane {w} wide with dilation "
                             f"{dmax} does not fit {SMEM_CAP} bytes")
    nbands = _ceil(h, bh)
    pb = 1
    if nbands == 1:
        pb = max(1, min(THREADS // (_ceil(h, RUN) * w), b * n))
        while pb > 1 and smem(pb, bh) > SMEM_CAP:
            pb -= 1
    return StackPlan(sched, pb, bh, nbands, lpad, sw,
                     _ceil(bh, RUN) * RUN + 2 * dmax, smem(pb, bh),
                     aligned and (h * w * itemsize) % 16 == 0, RUN * k)


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
    """Plain version: proj [B, n, H, W], taps packed [n, K*9]
    (`pack_taps`) -> [B, K*n, H, W], computed in f32, rounded once to
    proj.dtype."""
    k, n = len(dilations), weights.shape[0]
    return _stack_plain(proj, weights.t().reshape(k, 3, 3, n), dilations, 1)


def down_front_plain(x: torch.Tensor, proj: torch.Tensor,
                     weights: torch.Tensor, dilations: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x [B, nin, H, W], proj [B, n, H, W], weights
    [K, 3, 3, n] -> (pool [B, nin, H2, W2], branches [B, K*n, H2, W2])."""
    pool = F.avg_pool2d(x.to(torch.float32), 3, stride=2, padding=1,
                        count_include_pad=True).to(x.dtype)
    return pool, _stack_plain(proj, weights, dilations, 2)


def _check_dilations(dilations):
    if not 1 <= len(dilations) <= MAX_K or min(dilations) < 1:
        raise ValueError(f"kernel limit: 1..{MAX_K} branches, dilations >= 1")


@functools.lru_cache(maxsize=256)
def _stack_record(b, n, h, w, dilations, itemsize, aligned):
    """A call's launch arguments after proj, out and taps, up to the
    stream, built once per shape, as ③'s launch record is
    (`ops/pyrpool.py::_branch_record`): a forward issues 30 of these
    calls."""
    _check_dilations(dilations)
    plan = stack_plan(b, n, h, w, dilations, itemsize, aligned)
    k = len(dilations)
    return (1 if itemsize == 2 else 0, b, n, h, w, k,
            (ctypes.c_int * k)(*dilations), plan.sched, plan.pb, plan.bh,
            plan.lpad, plan.sw, plan.rows, int(plan.vec), plan.smem)


def _launch_stack(proj, weights, dilations):
    _cuda.require(proj, "proj", _DTYPES)
    b, n, h, w = proj.shape
    dil = tuple(int(d) for d in dilations)
    record = _stack_record(b, n, h, w, dil, proj.element_size(),
                           proj.data_ptr() % 16 == 0)
    _cuda.require(weights, "weights", (torch.float32,), (n, len(dil) * 9))
    out = torch.empty((b, len(dil) * n, h, w), dtype=proj.dtype,
                      device=proj.device)
    lib = _lib()
    err = lib.eesp_stack_launch(proj.data_ptr(), out.data_ptr(),
                                weights.data_ptr(), *record,
                                _cuda.stream(proj))
    _cuda.check(lib, err, "eesp_stack_launch")
    return out


def _launch_front(proj, x, weights, dilations):
    _cuda.require(proj, "proj", _DTYPES)
    b, n, h, w = proj.shape
    k = len(dilations)
    _check_dilations(dilations)
    taps = weights.to(device=proj.device, dtype=torch.float32).contiguous()
    _cuda.require(taps, "weights", (torch.float32,), (k, 3, 3, n))
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = torch.empty((b, k * n, ho, wo), dtype=proj.dtype, device=proj.device)
    _cuda.require(x, "x", (proj.dtype,))
    nin = x.shape[1]
    if (x.shape[0], x.shape[2], x.shape[3]) != (b, h, w):
        raise ValueError(f"x {tuple(x.shape)} does not match proj "
                         f"{tuple(proj.shape)}")
    pool = torch.empty((b, nin, ho, wo), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.eesp_branches_launch(
        _cuda.ptr(proj), _cuda.ptr(x), _cuda.ptr(out), _cuda.ptr(pool),
        _cuda.ptr(taps), 1 if proj.dtype == torch.bfloat16 else 0, b, n, nin,
        h, w, k, (ctypes.c_int * k)(*[int(d) for d in dilations]),
        _cuda.stream(proj))
    _cuda.check(lib, err, "eesp_branches_launch")
    return out, pool


def eesp_branches(proj: torch.Tensor, weights: torch.Tensor,
                  dilations: Sequence[int]) -> torch.Tensor:
    """Stride-1 EESP branch stack + HFF: proj [B, n, H, W], taps packed
    [n, K*9] f32 (`pack_taps`) -> [B, K*n, H, W] in proj.dtype.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if not proj.is_cuda:
        return eesp_branches_plain(proj, weights, dilations)
    out = _launch_stack(proj, weights, dilations)
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
    out, pool = _launch_front(proj, x, weights, dilations)
    down_front.launches += 1
    return pool, out


down_front.launches = 0


def _lib():
    lib = _cuda.load("eesp_branches")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.eesp_branches_launch
    if fn.argtypes is None:
        # proj, x, out, pool, taps, dtype, B, n, nin, H, W, K, dilations,
        # stream
        fn.argtypes = [vp] * 5 + [ci] * 7 + [ctypes.POINTER(ci), vp]
        fn.restype = ci
    fn = lib.eesp_stack_launch
    if fn.argtypes is None:
        # proj, out, taps, dtype, B, n, H, W, K, dilations, sched, pb, bh,
        # lpad, sw, rows, vec, smem, stream
        fn.argtypes = ([vp] * 3 + [ci] * 6 + [ctypes.POINTER(ci)] + [ci] * 8
                       + [vp])
        fn.restype = ci
    return lib
