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
  pool of the block input (count_include_pad=True).  Its branch kernel
  takes whole planes (or bands of output rows) a block, staged with even
  and odd columns apart, and 8-output column runs a thread; its pool
  kernel streams strips of 8 input columns down the rows (`front_plan`
  says how).  Under autograd it runs as `_DownFront`, whose backward
  differentiates the plain version, as the TPU kernel's custom VJP does
  its lax reference.  Nothing routes to it: the JAX package switches its
  kernel off (mspl_tpu/layers/eesp.py:111).

Layouts are NCHW, and both stacks take their taps packed by `pack_taps`
as [n, K*9] f32 (the `use_pallas` route caches that per unit; a caller
of `down_front` packs once too).  The kernels and the plain versions
accumulate the taps, the HFF sums and the pool's nine values in f32 and
round each output once to the input dtype (the TPU kernel of the
stride-1 stack multiplies in the input dtype).  csrc/eesp_branches.cu
holds the bounds and the design notes.
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
SMEM_MAX = 227 * 1024  # a block's shared memory on the H100
# the front's branch kernel: bands of level1's 128x240 planes at 32 KB
# (nine blocks an SM) read 6% faster than at 48 KB on the H100
FRONT_SMEM_CAP = 32 * 1024
# csrc/eesp_branches.cu FR_NT threads a block and FR_RUN outputs a thread of
# the front's branch kernel, FP_SEG output rows a pool thread walks down
FRONT_THREADS, FRONT_RUN, POOL_SEG = 128, 4, 16


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


class FrontPlan(NamedTuple):
    """How the DownSampler front's kernels cover a call.  The branch
    kernel: the instance (`sched`: 0 for (1,2,3,4), 1 for run-time
    dilations), planes a block (`pb`), output rows a band (`bh`, Ho
    unless a plane exceeds FRONT_SMEM_CAP) and bands a plane, a plane's
    shared layout (`rows` of two halves of `half` floats, the even image
    columns in the first and the odd ones in the second, image column 2i
    or 2i+1 at `lpad + i` of its half), the block's shared bytes, and
    whether it stages with 16-byte loads.  The pool kernel: input columns a thread's
    strip (8, or 4 where W is a multiple of 4 but not of 8, so that no
    strip is cut), bytes a load (16 or 8 where every row of x starts on
    such a word and a strip holds it, else 0: element by element) and
    outputs a store (up to half a strip, as Wo allows)."""
    sched: int
    pb: int
    bh: int
    nbands: int
    lpad: int
    half: int
    rows: int
    smem: int
    vec: bool
    pool_strip: int
    pool_load: int
    pool_store: int


def front_plan(b: int, n: int, h: int, w: int, dilations: Sequence[int],
               itemsize: int, proj_aligned: bool, x_align: int) -> FrontPlan:
    """The launch plan of `down_front` at proj [b, n, h, w] and x of the
    same plane, of `itemsize`-byte elements; `proj_aligned`: proj sits on
    a 16-byte word; `x_align`: the largest of 16, 8, 4, 2, 1 that divides
    x's address."""
    k, dmax = len(dilations), max(dilations)
    dil = tuple(int(d) for d in dilations)
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    reach = _ceil(dmax, 2)  # columns of a half the taps reach past the image
    lpad = _ceil(reach, 4) * 4
    half = _ceil(lpad + wo + reach, 4) * 4

    def smem(pb: int, bh: int) -> int:
        rows = 2 * _ceil(bh, FRONT_RUN) * FRONT_RUN + 2 * dmax
        return 4 * (_ceil(pb * k * 9, 4) * 4 + pb * rows * 2 * half)

    bh = ho
    if smem(1, ho) > FRONT_SMEM_CAP:
        # bands of whole runs within FRONT_SMEM_CAP; where not even one
        # run's rows fit, bands of one run, up to a block's shared memory
        fit = ((FRONT_SMEM_CAP // 4 - _ceil(k * 9, 4) * 4) // (2 * half)
               - 2 * dmax)
        bh = max(FRONT_RUN, fit // (2 * FRONT_RUN) * FRONT_RUN)
        if smem(1, bh) > SMEM_MAX:
            raise ValueError(f"kernel limit: a plane {w} wide with dilation "
                             f"{dmax} does not fit {SMEM_MAX} bytes")
    nbands = _ceil(ho, bh)
    pb = 1
    if nbands == 1:
        pb = max(1, min(FRONT_THREADS // (_ceil(ho, FRONT_RUN) * wo),
                        b * n))
        while pb > 1 and smem(pb, bh) > FRONT_SMEM_CAP:
            pb -= 1
    strip = 4 if w % 8 and w % 4 == 0 else 8
    pool_load = next((v for v in (16, 8) if v <= strip * itemsize
                      and (w * itemsize) % v == 0 and x_align % v == 0), 0)
    pool_store = next(g for g in (4, 2, 1) if 2 * g <= strip and wo % g == 0)
    return FrontPlan(0 if dil == (1, 2, 3, 4) else 1, pb, bh, nbands, lpad,
                     half, 2 * _ceil(bh, FRONT_RUN) * FRONT_RUN + 2 * dmax,
                     smem(pb, bh),
                     proj_aligned and (h * w * itemsize) % 16 == 0,
                     strip, pool_load, pool_store)


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
    """Plain version: x [B, nin, H, W], proj [B, n, H, W], taps packed
    [n, K*9] (`pack_taps`) -> (pool [B, nin, H2, W2], branches
    [B, K*n, H2, W2]), computed in f32, rounded once to the inputs'
    dtype."""
    k, n = len(dilations), weights.shape[0]
    pool = F.avg_pool2d(x.to(torch.float32), 3, stride=2, padding=1,
                        count_include_pad=True).to(x.dtype)
    return pool, _stack_plain(proj, weights.t().reshape(k, 3, 3, n),
                              dilations, 2)


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


def _align(t: torch.Tensor) -> int:
    """The largest of 16, 8, 4, 2, 1 that divides t's address."""
    return next(v for v in (16, 8, 4, 2, 1) if t.data_ptr() % v == 0)


@functools.lru_cache(maxsize=256)
def _front_record(b, n, nin, h, w, dilations, itemsize, proj_aligned,
                  x_align):
    """A front call's launch arguments after proj, x, out, pool and taps,
    up to the stream, built once per shape."""
    _check_dilations(dilations)
    plan = front_plan(b, n, h, w, dilations, itemsize, proj_aligned,
                      x_align)
    k = len(dilations)
    return (1 if itemsize == 2 else 0, b, n, nin, h, w, k,
            (ctypes.c_int * k)(*dilations), plan.sched, plan.pb, plan.bh,
            plan.lpad, plan.half, plan.rows, int(plan.vec), plan.smem,
            plan.pool_strip, plan.pool_load, plan.pool_store)


def _launch_front(x, proj, weights, dilations):
    _cuda.require(proj, "proj", _DTYPES)
    _cuda.require(x, "x", (proj.dtype,))
    b, n, h, w = proj.shape
    nin = x.shape[1]
    if (x.dim(), x.shape[0], x.shape[2], x.shape[3]) != (4, b, h, w):
        raise ValueError(f"x {tuple(x.shape)} does not match proj "
                         f"{tuple(proj.shape)}")
    dil = tuple(int(d) for d in dilations)
    record = _front_record(b, n, nin, h, w, dil, proj.element_size(),
                           proj.data_ptr() % 16 == 0, _align(x))
    _cuda.require(weights, "weights", (torch.float32,), (n, len(dil) * 9))
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = torch.empty((b, len(dil) * n, ho, wo), dtype=proj.dtype,
                      device=proj.device)
    pool = torch.empty((b, nin, ho, wo), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.down_front_launch(
        proj.data_ptr(), x.data_ptr(), out.data_ptr(), pool.data_ptr(),
        weights.data_ptr(), *record, _cuda.stream(proj))
    _cuda.check(lib, err, "down_front_launch")
    down_front.launches += 1
    return pool, out


class _DownFront(torch.autograd.Function):
    """The DownSampler front's kernels under autograd.  The forward
    launches them; the backward differentiates `down_front_plain`,
    recomputed from the saved inputs, as the TPU kernel's custom VJP is
    `jax.vjp` of its lax reference (mspl_tpu/ops/pallas_downsampler.py
    `_with_vjp`).  Gradients reach x, proj and the packed taps."""

    @staticmethod
    def forward(ctx, x, proj, weights, dilations):
        ctx.dilations = dilations
        ctx.save_for_backward(x, proj, weights)
        return _launch_front(x, proj, weights, dilations)

    @staticmethod
    def backward(ctx, grad_pool, grad_out):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip(saved, ctx.needs_input_grad)]
            outs = down_front_plain(*leaves, ctx.dilations)
            wrt = [t for t in leaves if t.requires_grad]
            # the pool has no gradient path when x needs none
            pairs = [(o, g) for o, g in zip(outs, (grad_pool, grad_out))
                     if g is not None and o.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs]))
        return (*(next(grads) if t.requires_grad else None for t in leaves),
                None)


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
    + HFF of proj), taps packed [n, K*9] f32 (`pack_taps`); see the plain
    version for the shapes.  CPU tensors take the plain version (under
    autograd, if it records); CUDA tensors launch the kernels (one call,
    counted once), through `_DownFront` when autograd records a gradient
    for an input."""
    if not proj.is_cuda:
        return down_front_plain(x, proj, weights, dilations)
    dil = tuple(int(d) for d in dilations)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, proj, weights)):
        return _DownFront.apply(x, proj, weights, dil)
    return _launch_front(x, proj, weights, dil)


down_front.launches = 0


def _lib():
    lib = _cuda.load("eesp_branches")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.down_front_launch
    if fn.argtypes is None:
        # proj, x, out, pool, taps, dtype, B, n, nin, H, W, K, dilations,
        # sched, pb, bh, lpad, half, rows, vec, smem, pool strip, pool load,
        # pool store, stream
        fn.argtypes = ([vp] * 5 + [ci] * 7 + [ctypes.POINTER(ci)] + [ci] * 11
                       + [vp])
        fn.restype = ci
    fn = lib.eesp_stack_launch
    if fn.argtypes is None:
        # proj, out, taps, dtype, B, n, H, W, K, dilations, sched, pb, bh,
        # lpad, sw, rows, vec, smem, stream
        fn.argtypes = ([vp] * 3 + [ci] * 6 + [ctypes.POINTER(ci)] + [ci] * 8
                       + [vp])
        fn.restype = ci
    return lib
