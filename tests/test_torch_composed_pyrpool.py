"""The band tables of the fused pyramid-pool tail kernel (kernel 2 of the
port, `csrc/pyrpool.cu` pyr_tail_kernel) on the CPU.

The kernel applies every branch as banded operators at source resolution:
these tests hold the port's band tables, made dense, to the JAX package's
composed operators (`_composed_up_mats`), and the band form applied in plain
PyTorch to the sequential branch stack, which is the algebra the kernel
relies on.  Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

from mspl_tpu.ops.pallas_pyrpool import _composed_up_mats
from mspl_tpu_torch.ops import pyrpool
from mspl_tpu_torch.ops.pyrpool import (BAND_KS, TAIL_TILE, band_table,
                                        branch_sizes, composed_ops,
                                        pyr_branches_band, pyr_branches_plain,
                                        scale_bands)

SCALES = (2.0, 1.5, 1.0, 0.5, 0.1)


def band_dense(start, wts, n_src):
    """The [E, n, n_src] operators that a band table stands for."""
    n, e, k = wts.shape
    out = np.zeros((e, n, n_src + k), np.float32)
    for j in range(k):
        out[:, np.arange(n), start + j] = wts[:, :, j].T
    return out[:, :, :n_src]


@pytest.mark.parametrize("h,w,s", [(128, 240, 2.0), (128, 240, 1.5),
                                   (2, 3, 2.0), (2, 3, 1.5), (13, 24, 2.0)])
def test_band_tables_match_composed_up_mats(h, w, s):
    """Row and column band tables, made dense, equal the JAX package's
    composed up-branch operators within 1e-6: P[e] = rows[e] and
    Q[e] = cols[e]^T.  (2, 3) is a plane where the branch sizes' clamp to
    5 bites."""
    (hs, ws), = branch_sizes(h, w, (s,))
    want_p, want_q = _composed_up_mats(h, w, hs, ws)
    (_, (rs, rw), (cs, cw)), = scale_bands(h, w, (s,))
    np.testing.assert_allclose(band_dense(rs, rw, h), want_p, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(band_dense(cs, cw, w).transpose(0, 2, 1),
                               want_q, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,s", [(128, 2.0), (240, 1.5), (128, 1.0),
                                 (7, 1.5), (16, 1.25), (30, 3.0), (2, 2.0)])
def test_band_table_is_exact_and_padded(n, s):
    """A band table holds every non-zero of its operators, its width is the
    widest band (3 or 4 at the main path's scales, where the kernel's
    instance is the next of BAND_KS; 5 at 1.25), and padding a band wider
    adds only zeros."""
    (n_s, _), = branch_sizes(n, n, (s,))
    ops = composed_ops(n, n_s, s)
    start, wts = band_table(ops)
    n_src = ops.shape[2]
    np.testing.assert_array_equal(band_dense(start, wts, n_src),
                                  ops.astype(np.float32))
    assert wts.shape[2] <= (5 if s == 1.25 else 4)
    start6, wts6 = band_table(ops, BAND_KS[-1])
    np.testing.assert_array_equal(start6, start)
    np.testing.assert_array_equal(band_dense(start6, wts6, n_src),
                                  ops.astype(np.float32))
    assert np.all(np.diff(start) >= 0)
    assert wts.shape[2] <= BAND_KS[-1]


def test_kernel_widths_at_the_main_path():
    """The main path's classifier plane takes composed bands of 3 (2.0,
    1.0) and 4 (1.5), the down scales their 2-tap resample back, and a
    1.25 scale on an odd plane a band of 5, which the kernel runs in its
    width-6 instance."""
    ks = [rw.shape[2] for _, (_, rw), _ in scale_bands(128, 240, SCALES)]
    assert ks == [3, 4, 3, 2, 2]
    (_, (_, rw), _), = scale_bands(37, 53, (1.25,))
    assert rw.shape[2] == 6


@pytest.mark.parametrize("h,w,scales", [(16, 24, SCALES), (9, 13, SCALES),
                                        (2, 3, SCALES),
                                        (11, 17, (3.0, 1.25, 0.25))])
def test_band_form_matches_branch_stack(h, w, scales):
    """The band form in plain PyTorch equals the sequential branch stack
    (resample, depthwise 3x3, resample back) at fp32 within 1e-5."""
    rng = np.random.default_rng(h * w)
    p = 3
    x = torch.from_numpy(rng.normal(0, 1, (2, p, h, w)).astype(np.float32))
    taps = torch.from_numpy(
        rng.normal(0, 0.5, (len(scales), 3, 3, p)).astype(np.float32))
    want = pyr_branches_plain(x, taps, scales)
    got = pyr_branches_band(x, taps, scales)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def _emulate_tail_branches(x, taps, scales):
    """The branch values the tail kernel forms, tile by tile, from the
    wrapper's per-tile tables alone (as csrc/pyrpool.cu pyr_tail_kernel
    reads them): each scale's source region staged with zeros past the
    plane's end (a down scale's source is the depthwise of its pooled
    plane), then the K x K stencils of the tile's branch rows and
    columns.  Returns [B, S*P, H, W] before the branch affine."""
    b, p, h, w = x.shape
    ks, tab_f, tab_i, x_cap, d_cap = pyrpool._tail_plan(h, w, scales, "cpu")
    th, tw = TAIL_TILE
    bh, bw = th + 2, tw + 2
    tiles_x = -(-w // tw)
    srcs = [x if s >= 1.0 else
            pyrpool._dw3x3(pyrpool.adaptive_avg_pool(x, hw_s), taps[i])
            for i, (s, hw_s) in enumerate(zip(scales,
                                              branch_sizes(h, w, scales)))]
    out = torch.zeros((b, len(scales) * p, h, w))
    for t in range(tab_f.shape[0]):
        y0, x0 = (t // tiles_x) * th, (t % tiles_x) * tw
        tf, ti = tab_f[t], tab_i[t].long()
        f = 0
        for si, (s, k, src) in enumerate(zip(scales, ks, srcs)):
            e = 3 if s >= 1.0 else 1
            rwp = -(-3 * k // 4) * 4 if s >= 1.0 else k  # padded rows
            cwt = tf[f:f + e * k * bw].reshape(e, k, bw)
            f += e * k * bw
            rwt = tf[f:f + bh * rwp].reshape(bh, rwp)[:, :e * k].reshape(
                bh, e, k)
            f += bh * rwp
            reg = ti[si * (4 + bh + bw):(si + 1) * (4 + bh + bw)]
            r0, q0, rows, pitch = (int(v) for v in reg[:4])
            rb, col = reg[4:4 + bh], reg[4 + bh:]
            assert rows * pitch <= (x_cap if s >= 1.0 else d_cap)
            pad = torch.zeros((b, p, r0 + rows, q0 + pitch))
            hs, ws = src.shape[2:]
            pad[:, :, :hs, :ws] = src[:, :, :r0 + rows, :q0 + pitch]
            region = pad[:, :, r0:, q0:].reshape(b, p, -1)
            tk = taps[si].permute(2, 0, 1)                   # [P, 3, 3]
            for rr in range(1, bh - 1):
                oy = y0 - 1 + rr
                for cx in range(1, bw - 1):
                    ox = x0 - 1 + cx
                    if oy >= h or ox >= w:
                        continue
                    start = int(rb[rr]) + int(col[cx])
                    idx = (start + torch.arange(k)[:, None] * pitch
                           + torch.arange(k)[None, :]).reshape(-1)
                    stencil = region[:, :, idx].reshape(b, p, k, k)
                    if e == 1:
                        v = torch.einsum("bpkl,l,k->bp", stencil,
                                         cwt[0, :, cx], rwt[rr, 0])
                    else:
                        bl = torch.einsum("pyx,xl->pyl", tk, cwt[:, :, cx])
                        v = torch.einsum("bpkl,pyl,yk->bp", stencil, bl,
                                         rwt[rr])
                    out[:, si * p:(si + 1) * p, oy, ox] = v
    return out


@pytest.mark.parametrize("h,w,scales", [(20, 40, SCALES),
                                        (9, 13, (2.0, 1.25, 1.0, 0.5, 0.1)),
                                        (2, 3, SCALES)])
def test_tail_tile_tables_give_the_branch_stack(h, w, scales):
    """The wrapper's per-tile tables, read as the kernel reads them (every
    region within its sized capacity), give the sequential branch stack at
    fp32 within 1e-5."""
    rng = np.random.default_rng(h + w)
    p = 2
    x = torch.from_numpy(rng.normal(0, 1, (1, p, h, w)).astype(np.float32))
    taps = torch.from_numpy(
        rng.normal(0, 0.5, (len(scales), 3, 3, p)).astype(np.float32))
    want = pyr_branches_plain(x, taps, scales)
    got = _emulate_tail_branches(x, taps, scales)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
