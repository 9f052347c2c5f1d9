"""The host-side layout of the branch-stack kernel (kernel 3 of the port,
`csrc/pyrpool.cu` pyr_branches_kernel) on the CPU.

The kernel computes every branch as banded stencils over full-width row
bands: these tests hold the band widths at the decoder's planes, and a
plain model of the kernel that reads only the wrapper's tables (its row
and column tables per scale, the staged x rows, each column's sliding
window of source rows, the down scales' pre-pass planes) to the
sequential branch stack and to the JAX package's branch stack.  Inputs
come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.ops.pallas_pyrpool import pyr_branches_pallas
from mspl_tpu_torch.ops import pyrpool
from mspl_tpu_torch.ops.pyrpool import (branch_sizes, pyr_branches_plain,
                                        scale_bands)
from mspl_tpu_torch.ops.resize import adaptive_avg_pool

SCALES = (2.0, 1.5, 1.0, 0.5, 0.1)
ODD_SCALES = (2.0, 1.25, 1.0, 0.5, 0.1)
# the decoder stages bu_dec_l1..l3 at 256x480
SHAPES = ((16, 30), (32, 60), (64, 120))


@pytest.mark.parametrize("h,w", SHAPES)
def test_band_widths_at_the_decoder_planes(h, w):
    """Composed bands of 3 (2.0), 4 (1.5) and 3 (1.0), and the down scales'
    2-tap resample back, at every plane of the branch stack (16x30 too,
    where the 0.1 scale's plane is clamped to 5x5); the kernel's plan
    takes the same widths."""
    ks = [rw.shape[2] for _, (_, rw), _ in scale_bands(h, w, SCALES)]
    assert ks == [3, 4, 3, 2, 2]
    lay = pyrpool._branch_plan(h, w, SCALES, "cpu")[0]
    assert lay[0::6] == ks


def _emulate_branches(x, taps, scales):
    """The branch stack as its kernels form it, from the wrapper's plan
    alone.  The band kernel, per band of `rb` rows: the x rows that the
    identity and up scales' bands read staged flat in f32 (W floats a row,
    at most `x_rows` rows, zero past the plane and in the X_PAD floats
    after them); per scale and per run of `rsub` rows of a column, the taps
    folded into the column weights, a window of K column sums slid down as
    the row starts advance, and each output formed from the row weights.
    The pre-pass, per plane: each down scale's pool + depthwise plane
    resampled back through the same row and column tables, 2 taps each.
    Vectorized over images, channels and columns."""
    b, p, h, w = x.shape
    lay, bt_i, bt_f, rb, nsub, rsub, x_rows = pyrpool._branch_plan(
        h, w, scales, "cpu")
    bt_i = bt_i.long()
    cols = torch.arange(w)
    out = torch.zeros((b, len(scales) * p, h, w))
    sizes = branch_sizes(h, w, scales)
    downs = [pyrpool._dw3x3(adaptive_avg_pool(x, hw_s), taps[i])
             if s < 1.0 else None
             for i, (s, hw_s) in enumerate(zip(scales, sizes))]
    tabs = []
    for si in range(len(scales)):
        k, rwp, o_rs, o_cs, o_rw, o_cw = lay[6 * si:6 * si + 6]
        e = 1 if downs[si] is not None else 3
        tabs.append((k, e, bt_i[o_rs:o_rs + h], bt_i[o_cs:o_cs + w],
                     bt_f[o_rw:o_rw + h * rwp].reshape(h, rwp)[:, :e * k]
                     .reshape(h, e, k),
                     bt_f[o_cw:o_cw + w * e * k].reshape(w, e, k)))
    flat_x = x.reshape(b, p, h * w)
    for y0 in range(0, h, rb):
        nrows = min(rb, h - y0)
        xs = [t for t, d in zip(tabs, downs) if d is None]
        r0 = min(int(t[2][y0]) for t in xs)
        r1 = max(int(t[2][y0 + nrows - 1]) + t[0] for t in xs)
        assert r1 - r0 <= x_rows
        s_x = torch.zeros((b, p, x_rows * w + pyrpool.X_PAD))
        n = min(r1 * w, h * w) - r0 * w
        s_x[:, :, :n] = flat_x[:, :, r0 * w:r0 * w + n]
        for si, ((k, e, rs, cs, rw, cw), d) in enumerate(zip(tabs, downs)):
            if d is None:
                # B[p][ey][l][x] = sum_ex tap[ey, ex, p] * cw[x][ex][l]
                bl = torch.einsum("yep,xel->pylx", taps[si], cw)

                def col_sums(r):
                    q = s_x[..., (r - r0) * w + cs[:, None] + torch.arange(k)]
                    return torch.einsum("bpxl,pelx->bpex", q, bl)
            else:
                continue
            for sub in range(nsub):
                ya, yb = sub * rsub, min(sub * rsub + rsub, nrows)
                if ya >= yb:
                    continue
                cur = int(rs[y0 + ya])
                win = [col_sums(cur + j) for j in range(k)]
                for yy in range(ya, yb):
                    y = y0 + yy
                    while cur < int(rs[y]):
                        cur += 1
                        win = win[1:] + [col_sums(cur + k - 1)]
                    v = sum(rw[y, ey, j] * win[j][:, :, ey]
                            for j in range(k) for ey in range(e))
                    out[:, si * p:(si + 1) * p, y, cols] = v
    for si, ((k, e, rs, cs, rw, cw), d) in enumerate(zip(tabs, downs)):
        if d is not None:  # the pre-pass: the whole plane
            hs, ws = d.shape[2:]
            ra = d[:, :, rs]                                   # [b,p,h,ws]
            rn = d[:, :, torch.clamp(rs + 1, max=hs - 1)]
            qb = torch.clamp(cs + 1, max=ws - 1)

            def resample(row):
                return cw[:, 0, 0] * row[..., cs] + cw[:, 0, 1] * row[..., qb]
            out[:, si * p:(si + 1) * p] = (rw[:, 0, 0, None] * resample(ra)
                                           + rw[:, 0, 1, None] * resample(rn))
    return out


@pytest.mark.parametrize("h,w,scales", [(16, 30, SCALES), (32, 60, SCALES),
                                        (64, 120, SCALES),
                                        (9, 13, SCALES),
                                        (37, 53, ODD_SCALES),
                                        (2, 3, SCALES)])
def test_kernel_layout_gives_the_branch_stack(h, w, scales):
    """The plain model of the kernel's host-side layout gives the
    sequential branch stack at fp32 within 1e-5, at the decoder's three
    planes and at odd ones (a width-6 band at 1.25, a tiny plane where the
    branch sizes' clamp to 5 bites)."""
    rng = np.random.default_rng(h * 1000 + w)
    p = 2
    x = torch.from_numpy(rng.normal(0, 1, (2, p, h, w)).astype(np.float32))
    taps = torch.from_numpy(
        rng.normal(0, 0.5, (len(scales), 3, 3, p)).astype(np.float32))
    want = pyr_branches_plain(x, taps, scales)
    got = _emulate_branches(x, taps, scales)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w", [(16, 30), (9, 13)])
def test_kernel_layout_matches_pallas(h, w):
    """The same model against the JAX package's branch stack (NHWC in,
    NHWC out; the Pallas kernel in interpret mode), fp32 within 1e-4 (the
    JAX path sums its resample products in a different order)."""
    rng = np.random.default_rng(7 * h + w)
    p = 3
    x = rng.normal(0, 1, (2, h, w, p)).astype(np.float32)
    taps = rng.normal(0, 0.5, (len(SCALES), 3, 3, p)).astype(np.float32)
    want = np.asarray(pyr_branches_pallas(jnp.asarray(x), jnp.asarray(taps),
                                          SCALES, interpret=True))
    got = _emulate_branches(torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(taps), SCALES)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-4)
