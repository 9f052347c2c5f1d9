"""Pyramid-pool decoder kernels: the CUDA kernels of `csrc/pyrpool.cu` and
their plain PyTorch versions.

* `pyr_branches` replaces mspl_tpu/ops/pallas_pyrpool.py::pyr_branches_pallas
  (the five-scale branch stack of bu_dec_l1..l3 in eval, of every decoder
  stage in train).  It is differentiable: as the TPU kernel's custom VJP
  differentiates the jnp reference, its backward is autograd through
  `pyr_branches_plain`, recomputed from the saved input and weights.
* `pyr_pool_fused_eval` replaces pyr_pool_fused_eval_v3 and its v2/v1
  fallbacks (one contract): the whole eval EfficientPyrPool after the proj
  conv, for the classifier stage bu_dec_l4.

Both kernels apply each branch as banded operators at source resolution:
the host builds the band tables (`scale_bands`), lays them out per scale
for the branch stack's full-width row bands (`_branch_plan`) and per
output tile for the tail (`_tail_plan`); `pyr_branches_band` is the same
algebra in plain PyTorch.  Both pool the down scales and take their
depthwise in one pre-pass (`csrc/pyrpool.cu` down_plane), from the bins of
`_down_plan`: the tail's in a launch of its own, the branch stack's as the
first blocks of its one launch, which also write those branches.

Both take channel-major [B, P, H, W] input, the layout the TPU kernels work
in after their entry transpose, and return [B, S*P, H, W] and [B, O, H, W].
csrc/pyrpool.cu holds the bound and the design note.  The kernels and the
plain versions compute in f32 and round once to the input dtype (the JAX
path rounds bf16 after every resample matmul).
"""

from __future__ import annotations

import ctypes
import math
from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mspl_tpu_torch.ops import _cuda
from mspl_tpu_torch.ops.resize import (_interp_matrix, adaptive_avg_pool,
                                       adaptive_bins, resize_bilinear)

MAX_P, MAX_S = 16, 8
BRANCH_ROWS = 16  # output rows of a branch-stack block (a full-width band)
BRANCH_THREADS = 128  # its threads (csrc/pyrpool.cu BR_NT)
BRANCH_SMEM = 227 * 1024  # a block's shared memory at most (bytes)
X_PAD = 6  # staged zeros after the x rows: the widest band's overhang
TAIL_TILE = (16, 30)  # the tail kernel's output tile (BTH, BTW)
TAIL_THREADS = 32 * 16  # its block, one thread per branch column and row
BAND_KS = (3, 4, 6)  # the tail kernel's band widths (template K)
# a tail block's shared memory: half of an SM's 228 KB, less the 1 KB the
# SM reserves for each block
TAIL_SMEM_FLOATS = (228 * 1024 // 2 - 1024) // 4
_DTYPES = (torch.float32, torch.bfloat16)
_KIND_ID, _KIND_UP, _KIND_DOWN = 0, 1, 2
# the plans each kind ("down", "branch", "record", "tail") keeps, keyed by
# call shape and device, the least recently used dropped past
# PLAN_CACHE_SIZE: each new plane shape (a new crop size in training, say)
# adds an entry
PLAN_CACHE_SIZE = 32
_plan_cache: Dict[str, "OrderedDict[tuple, tuple]"] = {}


def _cached(kind: str, key: tuple):
    """The `kind` plan of `key`, or None; a hit becomes the most recent."""
    lru = _plan_cache.setdefault(kind, OrderedDict())
    hit = lru.get(key)
    if hit is not None:
        lru.move_to_end(key)
    return hit


def _keep(kind: str, key: tuple, plan: tuple) -> tuple:
    """Cache `plan` as the most recent of its kind; returns it."""
    lru = _plan_cache.setdefault(kind, OrderedDict())
    lru[key] = plan
    while len(lru) > PLAN_CACHE_SIZE:
        lru.popitem(last=False)
    return plan


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


def _down_plan(h: int, w: int, scales: Tuple[float, ...], device):
    """Per-scale kinds and branch sizes, and the down scales'
    adaptive-average bins packed for the pre-pass (per down scale its row
    bins then its column bins, (index, weight) pairs) on the device; cached
    per shape."""
    key = (h, w, scales, str(device))
    hit = _cached("down", key)
    if hit is not None:
        return hit
    kinds, idx, wgt = [], [], []
    sizes = branch_sizes(h, w, scales)
    for s, (hs, ws) in zip(scales, sizes):
        kinds.append(_KIND_ID if s == 1.0 else
                     _KIND_UP if s > 1.0 else _KIND_DOWN)
        if s < 1.0:
            for tab in (adaptive_bins(h, hs), adaptive_bins(w, ws)):
                idx.append(tab[0].reshape(-1))
                wgt.append(tab[1].reshape(-1))
    itab = torch.from_numpy(np.concatenate(idx or [np.zeros(1, np.int32)]))
    ftab = torch.from_numpy(np.concatenate(wgt or [np.zeros(1, np.float32)]))
    hit = (kinds, sizes, itab.to(device), ftab.to(device))
    return _keep("down", key, hit)


def _shift_op(n: int, e: int) -> np.ndarray:
    """[n, n] shift: (S y)[r] = y[r + e], zero outside (the depthwise 3x3's
    'same' padding at branch resolution)."""
    return np.eye(n, k=e)


def composed_ops(n: int, n_s: int, s: float) -> np.ndarray:
    """[3, n, n] f64 operators of one axis of an identity or up scale's
    branch, one per depthwise offset e = -1, 0, 1, so that

        branch = sum_{ey,ex} tap[ey, ex] * M_h[ey] @ x @ M_w[ex]^T

    with M[e] = back @ S_e @ to (S_e for the identity scale), S_e the
    shift at branch resolution [n_s].  Built in f64 from the f32
    interpolation matrices that the plain version multiplies by."""
    if s < 1.0:
        raise ValueError("composed operators are for identity and up scales")
    shifts = [_shift_op(n if s == 1.0 else n_s, e) for e in (-1, 0, 1)]
    if s == 1.0:
        return np.stack(shifts)
    back = _interp_matrix(n_s, n, True).astype(np.float64)       # [n, n_s]
    to = _interp_matrix(n, n_s, True).astype(np.float64)         # [n_s, n]
    return np.stack([back @ sh @ to for sh in shifts])


def band_table(ops: np.ndarray, k: int = 0):
    """Band form of `composed_ops` (or of any [E, n, n_src] operators):
    (start int32 [n], weights f32 [n, E, K]) with ops[e, y, start[y] + j] =
    weights[y, e, j]; K is the widest row's band over the offsets, or `k`
    if larger.  A band may run past the source's end, where its weights
    are 0.  Raises unless the starts are non-decreasing (the kernel bounds
    a tile's source rows by its end rows)."""
    nz = np.any(ops != 0, axis=0)
    n, n_src = nz.shape
    start = np.where(nz.any(1), nz.argmax(1), 0)
    end = np.where(nz.any(1), n_src - 1 - nz[:, ::-1].argmax(1), 0)
    k = max(k, int((end - start + 1).max()))
    if np.any(np.diff(start) < 0):
        raise ValueError("band starts are not monotone")
    wts = np.zeros((n, ops.shape[0], k), np.float64)
    for j in range(k):
        col = start + j
        ok = col < n_src
        wts[ok, :, j] = ops[:, ok, col[ok]].T
    return start.astype(np.int32), wts.astype(np.float32)


def _kernel_k(k: int) -> int:
    """The tail kernel's band width for a band of `k`: the smallest of
    BAND_KS that holds it."""
    for kk in BAND_KS:
        if k <= kk:
            return kk
    raise ValueError(f"kernel limit: a band of {k} > {BAND_KS[-1]}")


def scale_bands(h: int, w: int, scales: Sequence[float]):
    """The tail kernel's bands per scale: (source size, (row start, row
    weights [H, E, K]), (column start, column weights [W, E, K])).  An
    identity or up scale reads x through the composed operators of its
    E = 3 depthwise offsets, its band padded to the kernel's width; a down
    scale reads the depthwise 3x3 of its adaptive-average plane (a pre-pass
    computes both at branch resolution) through the bilinear resample back
    alone: E = 1, K = 2."""
    out = []
    for s, (hs, ws) in zip(scales, branch_sizes(h, w, scales)):
        if s < 1.0:
            rows = _interp_matrix(hs, h, True).astype(np.float64)[None]
            cols = _interp_matrix(ws, w, True).astype(np.float64)[None]
            out.append(((hs, ws), band_table(rows, 2), band_table(cols, 2)))
            continue
        rows, cols = composed_ops(h, hs, s), composed_ops(w, ws, s)
        k = _kernel_k(max(band_table(rows)[1].shape[2],
                          band_table(cols)[1].shape[2]))
        out.append(((h, w), band_table(rows, k), band_table(cols, k)))
    return out


def pyr_branches_band(x: torch.Tensor, weights: torch.Tensor,
                      scales: Sequence[float]) -> torch.Tensor:
    """The branch stack in the tail kernel's band form, in f32: for each
    scale, the source plane's rows and columns gathered at each band start
    and weighted by the band tables, one sum per depthwise offset pair (a
    down scale's source is already the depthwise of its pooled plane).
    Equals `pyr_branches_plain` up to f32 summation order."""
    xf = x.to(torch.float32)
    wf = weights.to(torch.float32)
    h, w = x.shape[2], x.shape[3]
    branches = []
    for i, (s, (src_hw, (rs, rw), (cs, cw))) in enumerate(
            zip(scales, scale_bands(h, w, scales))):
        src = xf if s >= 1.0 else _dw3x3(adaptive_avg_pool(xf, src_hw),
                                         wf[i])
        k = rw.shape[2]

        def gather(t, start, dim, n_src):
            idx = torch.from_numpy(np.minimum(start[:, None] + np.arange(k),
                                              n_src - 1).astype(np.int64))
            return t.index_select(dim, idx.reshape(-1)).unflatten(
                dim, (len(start), k))

        rows = gather(src, rs, 2, src_hw[0])             # [B, P, h, k, Ws]
        t = torch.einsum("bpykx,yek->bpeyx", rows, torch.from_numpy(rw))
        cols = gather(t, cs, 4, src_hw[1])               # [B,P,3,h,w,k]
        u = torch.einsum("bpeyxl,xfl->bpefyx", cols, torch.from_numpy(cw))
        branches.append(u[:, :, 0, 0] if s < 1.0 else
                        torch.einsum("bpefyx,efp->bpyx", u, wf[i]))
    return torch.cat(branches, dim=1).to(x.dtype)


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def _branch_plan(h: int, w: int, scales: Tuple[float, ...], device):
    """The branch-stack kernel's tables and launch shape; cached per shape.

    Per scale, its band tables of `scale_bands` as the kernel reads them:
    row starts [H] and column starts [W] (ints), row weights [H][rwp] and
    column weights [W][E*K] (floats; rwp = E*K, padded to a multiple of 4
    for an identity or up scale, whose rows are read as 16-byte words; each
    table starts on a 16-byte word).  `lay` [S * 6] holds each scale's K,
    rwp and the offsets of its row starts, column starts, row weights and
    column weights.  The pre-pass writes the down scales' branches through
    their tables; the band kernel takes the identity and up scales'.  A
    block takes `rb` full-width output rows, as many as 16 whose staging
    fits its shared memory; a thread a column and a run of `rsub` of them
    (`nsub` runs a band, so that a block has work for its threads at
    narrow planes).  It stages, flat, the x rows that the bands of its band
    read (at most `x_rows`, then a pad of X_PAD zeros for the bands'
    overhang past the last column).  Returns (lay, ints, floats, rb, nsub,
    rsub, x_rows)."""
    key = ("branch", h, w, scales, str(device))
    hit = _cached("branch", key)
    if hit is not None:
        return hit
    lay, ints, floats, bands = [], [], [], []
    n_i = n_f = 0
    for s, ((hs, ws), (rs, rw), (cs, cw)) in zip(scales,
                                                 scale_bands(h, w, scales)):
        k = rw.shape[2]
        rw = rw.reshape(h, -1)
        rwp = rw.shape[1] if s < 1.0 else _up4(rw.shape[1])
        rw = np.pad(rw, ((0, 0), (0, rwp - rw.shape[1]))).reshape(-1)
        cw = cw.reshape(-1)
        f_rw = n_f
        f_cw = f_rw + _up4(rw.size)
        lay += [k, rwp, n_i, n_i + h, f_rw, f_cw]
        ints += [rs, cs]
        floats += [rw, np.zeros(f_cw - f_rw - rw.size, np.float32), cw,
                   np.zeros(_up4(cw.size) - cw.size, np.float32)]
        n_i += h + w
        n_f = f_cw + _up4(cw.size)
        bands.append((s, hs, ws, rs, k))

    def x_rows_of(rb):
        """The most x rows that a band of rb rows stages."""
        x_rows = 1
        for y0 in range(0, h, rb):
            y1 = min(y0 + rb, h) - 1
            xs = [(int(rs[y0]), int(rs[y1]) + k)
                  for s, _, _, rs, k in bands if s >= 1.0]
            if xs:
                x_rows = max(x_rows, max(hi for _, hi in xs)
                             - min(lo for lo, _ in xs))
        return x_rows

    for rb in range(min(BRANCH_ROWS, h), 0, -1):
        x_rows = x_rows_of(rb)
        if 4 * (len(scales) * _up4(rb * w) + x_rows * w
                + X_PAD) <= BRANCH_SMEM:
            break
    else:
        raise ValueError(f"kernel limit: a row of {w} does not fit")
    nsub = max(1, min(rb, BRANCH_THREADS // w))
    rsub = -(-rb // nsub)
    hit = (lay, torch.from_numpy(np.concatenate(ints).astype(np.int32)).to(
        device), torch.from_numpy(np.concatenate(floats).astype(
            np.float32)).to(device), rb, nsub, rsub, x_rows)
    return _keep("branch", key, hit)


def _branch_record(b: int, p: int, h: int, w: int,
                   scales: Tuple[float, ...], dtype, device):
    """One launch of the branch stack's kernels packed for a short ctypes
    call, cached per call shape: the int record that csrc/pyrpool.cu
    pyr_branches_launch reads and the table pointers.  Returns (record
    address, tables address, the ctypes arrays that own both)."""
    key = ("record", b, p, h, w, scales, dtype, str(device))
    hit = _cached("record", key)
    if hit is not None:
        return hit
    kinds, sizes, itab, ftab = _down_plan(h, w, scales, device)
    lay, bt_i, bt_f, rb, nsub, rsub, x_rows = _branch_plan(h, w, scales,
                                                           device)
    per_scale = []
    for si, (kind, (hs, ws)) in enumerate(zip(kinds, sizes)):
        k, _, o_rs, o_cs, o_rw, o_cw = lay[6 * si:6 * si + 6]
        per_scale += [kind, hs, ws, k, o_rs, o_cs, o_rw, o_cw]
    cfg = [1 if dtype == torch.bfloat16 else 0, b, p, h, w, len(scales), rb,
           nsub, rsub, x_rows * w + X_PAD] + per_scale
    cfg = (ctypes.c_int * len(cfg))(*cfg)
    tabs = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in (itab, ftab, bt_i,
                                                           bt_f)])
    # the record owns the tables it points at: a plan of another kind may
    # leave its cache first
    hit = (ctypes.addressof(cfg), ctypes.addressof(tabs),
           (cfg, tabs, itab, ftab, bt_i, bt_f))
    return _keep("record", key, hit)


def _tail_plan(h: int, w: int, scales: Tuple[float, ...], device):
    """The tail kernel's per-tile tables on the device and their sizes;
    cached per shape.  For each 16 x 30 output tile and each scale: the
    column weights of the tile's 32 branch columns [3K][32] (0 outside the
    image) and the row weights of its 18 branch rows [18][3K] (each row
    padded to a multiple of 4; floats); the source region the scale reads
    (r0, q0, rows, pitch: the union of the identity and up scales' regions
    in x, or the down scale's own), each branch row's first staged element
    and each branch column's first staged column (ints); then the x
    region.  A down scale's weights are [2][32] and [18][2] (its bilinear
    resample back).  Returns (K per scale, float tables [tiles, tile_f],
    int tables [tiles, tile_i], x_cap, d_cap: the floats of one channel's
    x region and of a down scale's region)."""
    key = ("tail", h, w, scales, str(device))
    hit = _cached("tail", key)
    if hit is not None:
        return hit
    th, tw = TAIL_TILE
    bh, bw = th + 2, tw + 2
    bands = scale_bands(h, w, scales)
    ks = [rw.shape[2] for _, (_, rw), _ in bands]
    tab_f, tab_i = [], []
    x_cap = d_cap = 1
    for y0 in range(0, h, th):
        gy = np.clip(np.arange(y0 - 1, y0 - 1 + bh), 0, h - 1)
        ylo, yhi = max(y0 - 1, 0), min(y0 + th, h - 1)
        for x0 in range(0, w, tw):
            gx = np.arange(x0 - 1, x0 - 1 + bw)
            col_in = (gx >= 0) & (gx < w)
            gxc = np.clip(gx, 0, w - 1)
            xlo, xhi = max(x0 - 1, 0), min(x0 + tw, w - 1)
            regs = [(int(rs[ylo]), int(cs[xlo]), int(rs[yhi]) + k,
                     int(cs[xhi]) + k)
                    for (_, (rs, _), (cs, _)), k in zip(bands, ks)]
            x_regs = [r for r, s in zip(regs, scales) if s >= 1.0]
            xr = ((min(r[0] for r in x_regs), min(r[1] for r in x_regs),
                   max(r[2] for r in x_regs), max(r[3] for r in x_regs))
                  if x_regs else (0, 0, 0, 0))
            fl, it = [], []
            for s, k, reg, (_, (rs, rw), (cs, cw)) in zip(scales, ks, regs,
                                                          bands):
                r0, q0, r1, q1 = xr if s >= 1.0 else reg
                pitch = q1 - q0
                if s < 1.0:
                    d_cap = max(d_cap, (r1 - r0) * pitch)
                cwt = cw[gxc] * col_in[:, None, None]      # [32, E, K]
                rwt = rw[gy].reshape(bh, -1)               # [18, E*K]
                if s >= 1.0:  # rows padded to whole 16-byte words
                    rwt = np.pad(rwt, ((0, 0), (0, -rwt.shape[1] % 4)))
                fl += [cwt.reshape(bw, -1).T.reshape(-1), rwt.reshape(-1)]
                it += [[r0, q0, r1 - r0, pitch], (rs[gy] - r0) * pitch,
                       np.where(col_in, cs[gxc] - q0, 0)]
            r0, q0, r1, q1 = xr
            x_cap = max(x_cap, (r1 - r0) * (q1 - q0))
            it.append([r0, q0, r1 - r0, q1 - q0])
            tab_f.append(np.concatenate(fl).astype(np.float32))
            tab_i.append(np.concatenate([np.asarray(v, np.int64)
                                         for v in it]).astype(np.int32))
    tab_f, tab_i = np.stack(tab_f), np.stack(tab_i)
    hit = (ks, torch.from_numpy(tab_f).to(device),
           torch.from_numpy(tab_i).to(device), x_cap, d_cap)
    return _keep("tail", key, hit)


def _group(p: int, per_ch: int, budget: int) -> int:
    """Channels a block stages together: as many as `budget` floats of
    shared memory hold when each takes `per_ch`."""
    return max(1, min(p, budget // per_ch))


class _PyrBranches(torch.autograd.Function):
    """The branch-stack kernel under autograd.  The forward launches the
    kernel.  The backward differentiates `pyr_branches_plain`, recomputed
    from the saved x and weights: the TPU kernel's custom VJP is `jax.vjp`
    of its jnp reference (mspl_tpu/ops/pallas_pyrpool.py
    `_branches_with_vjp`), so
    this is the one place where a plain version runs on the card, by the
    reference's design.  Gradients reach x and the f32 [S, 3, 3, P]
    weights."""

    @staticmethod
    def forward(ctx, x, weights, scales):
        ctx.scales = scales
        ctx.save_for_backward(x, weights)
        return _launch_branches(x, weights, scales)

    @staticmethod
    def backward(ctx, grad_out):
        x, weights = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(ctx.needs_input_grad[0])
            wr = weights.detach().requires_grad_(ctx.needs_input_grad[1])
            out = pyr_branches_plain(xr, wr, ctx.scales)
            wrt = [t for t in (xr, wr) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad_out))
        return (next(grads) if xr.requires_grad else None,
                next(grads) if wr.requires_grad else None, None)


def pyr_branches(x: torch.Tensor, weights: torch.Tensor,
                 scales: Sequence[float]) -> torch.Tensor:
    """Five-scale branch stack: x [B, P, H, W], weights [S, 3, 3, P] ->
    [B, S*P, H, W] (channel si*P + c) in x.dtype.  CPU tensors take the
    plain version (under autograd, if it records); CUDA tensors launch the
    kernel (one launch: pre-pass blocks write the down scales' branches,
    band blocks the others), through `_PyrBranches` when autograd
    records a gradient for x or the weights."""
    if not x.is_cuda:
        return pyr_branches_plain(x, weights, scales)
    scales = tuple(scales)
    if torch.is_grad_enabled() and (x.requires_grad or weights.requires_grad):
        return _PyrBranches.apply(x, weights, scales)
    return _launch_branches(x, weights, scales)


def _launch_branches(x: torch.Tensor, weights: torch.Tensor,
                     scales: Tuple[float, ...]) -> torch.Tensor:
    """One launch of the branch-stack kernel (see `pyr_branches`)."""
    _cuda.require(x, "x", _DTYPES)
    b, p, h, w = x.shape
    if len(scales) > MAX_S:
        raise ValueError(f"kernel limit: S <= {MAX_S}")
    weights = weights.to(device=x.device, dtype=torch.float32).contiguous()
    _cuda.require(weights, "weights", (torch.float32,), (len(scales), 3, 3, p))
    cfg, tabs, _ = _branch_record(b, p, h, w, scales, x.dtype, x.device)
    out = torch.empty((b, len(scales) * p, h, w), dtype=x.dtype,
                      device=x.device)
    lib = _lib()
    _cuda.check(lib, lib.pyr_branches_launch(
        cfg, tabs, x.data_ptr(), weights.data_ptr(), out.data_ptr(),
        _cuda.stream(x)), "pyr_branches_launch")
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
    _cuda.require(x, "x", _DTYPES)
    b, p, h, w = x.shape
    scales = tuple(scales)
    s_n, o = len(scales), cls_w.shape[1]
    if p > MAX_P:
        raise ValueError(f"kernel limit: P <= {MAX_P}")
    if s_n > MAX_S:
        raise ValueError(f"kernel limit: S <= {MAX_S}")
    dw_weights = dw_weights.to(device=x.device, dtype=torch.float32
                               ).contiguous()
    _cuda.require(dw_weights, "dw_weights", (torch.float32,), (s_n, 3, 3, p))
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
    ks, tab_f, tab_i, x_cap, d_cap = _tail_plan(h, w, scales, x.device)
    g, _ = _tail_smem(p, o, scales, tab_f.shape[1], tab_i.shape[1], x_cap,
                      d_cap)
    kinds, sizes, itab, ftab = _down_plan(h, w, scales, x.device)
    # the down scales' depthwise planes (f32), filled by the pre-pass
    scratch = [torch.empty((b * p, hs, ws), dtype=torch.float32,
                           device=x.device) if k == _KIND_DOWN else None
               for k, (hs, ws) in zip(kinds, sizes)]
    ci = ctypes.c_int * s_n
    lib = _lib()
    err = lib.pyr_tail_launch(
        _cuda.ptr(x), 1 if x.dtype == torch.bfloat16 else 0, b, p, h, w, s_n,
        ci(*kinds), ci(*[hs for hs, _ in sizes]), ci(*[ws for _, ws in sizes]),
        _cuda.ptr(itab), _cuda.ptr(ftab), _cuda.ptr(dw_weights),
        _cuda.ptr(params), o, g, ci(*ks), _cuda.ptr(tab_f), _cuda.ptr(tab_i),
        tab_f.shape[1], tab_i.shape[1],
        (ctypes.c_void_p * s_n)(*[None if t is None else t.data_ptr()
                                  for t in scratch]),
        x_cap, d_cap, _cuda.ptr(out), _cuda.stream(x))
    _cuda.check(lib, err, "pyr_tail_launch")
    pyr_pool_fused_eval.launches += 1
    return out


pyr_pool_fused_eval.launches = 0


def _tail_smem(p: int, o: int, scales: Sequence[float], tile_f: int,
               tile_i: int, x_cap: int, d_cap: int):
    """(channels a tail block stages together, its shared-memory bytes).
    Outside the channel group a block holds its parameters (the merge taps
    in rows of 12, the classifier in rows of P rounded up to 4 beside its
    bias and affine) and taps, each region on a 16-byte word, each
    thread's P merge sums and its tile's tables; per channel, its x region,
    each down scale's region and two buffers of branch values of the tile
    and its merge halo.  The group is as many channels as half of an SM's
    shared memory holds, so that two 512-thread blocks share an SM (the
    kernel's register bound)."""
    bw, bh = TAIL_TILE[1] + 2, TAIL_TILE[0] + 2
    sp_n = len(scales) * p
    fixed = (_up4(3 * sp_n + 3 * p) + _up4(9 * sp_n) + 12 * sp_n
             + o * (_up4(p) + 4) + p * TAIL_THREADS + tile_f + tile_i)
    per_ch = (x_cap + sum(1 for s in scales if s < 1.0) * d_cap
              + 2 * bh * bw)
    g = _group(p, per_ch, TAIL_SMEM_FLOATS - fixed)
    return g, 4 * (fixed + g * per_ch)


def tail_blocks_per_sm(x: torch.Tensor, p: int, o: int,
                       scales: Sequence[float]) -> int:
    """Blocks of the tail kernel that one SM holds at `x`'s shape, as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor reports it for the
    shared memory that `pyr_pool_fused_eval` gives a launch."""
    _, _, h, w = x.shape
    ks, tab_f, tab_i, x_cap, d_cap = _tail_plan(h, w, tuple(scales),
                                                x.device)
    _, smem = _tail_smem(p, o, scales, tab_f.shape[1], tab_i.shape[1],
                         x_cap, d_cap)
    blocks = ctypes.c_int(0)
    lib = _lib()
    err = lib.pyr_tail_occupancy(1 if x.dtype == torch.bfloat16 else 0,
                                 max(k for k, s in zip(ks, scales)
                                     if s >= 1.0), smem, ctypes.byref(blocks))
    _cuda.check(lib, err, "pyr_tail_occupancy")
    return blocks.value


def _lib():
    lib = _cuda.load("pyrpool")
    if lib.pyr_branches_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # the launch record, the tables, x, taps, out, stream
        lib.pyr_branches_launch.argtypes = [vp] * 6
        # x, dtype..S, kinds..taps; params, O, g, band K per scale, the
        # tiles' float and int tables and their sizes; scratch, the x and
        # down-scale regions' floats, out, stream
        lib.pyr_tail_launch.argtypes = ([vp] + [ci] * 6 + [vp] * 6
                                        + [vp, ci, ci, vp, vp, vp, ci, ci]
                                        + [vp, ci, ci, vp, vp])
        lib.pyr_tail_occupancy.argtypes = [ci, ci, ci, vp]
        for fn in (lib.pyr_branches_launch, lib.pyr_tail_launch,
                   lib.pyr_tail_occupancy):
            fn.restype = ci
    return lib
