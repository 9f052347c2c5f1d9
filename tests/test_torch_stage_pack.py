"""The fused EESP stage kernel's host side (`mspl_tpu_torch/ops/eesp_stage.py`)
on the CPU: the packed split-bf16 operands of its two tensor-core products,
a plain-torch emulation of the kernel's split arithmetic on those packed
arrays against the plain version, and the tiling that models its shared
memory.  Nothing is compiled or launched here; these catch layout and
padding errors before the kernel runs on a card.

Units are built as `tests/test_torch_encoder_kernels.py::_chain` builds
them (flax EESP variables with perturbed statistics loaded into port
units).  The cases: c = 64 with K = 4 (grouped proj 16 -> 4 per group,
padded to 16 rows; grouped expand 16 -> 16), c = 24 with K = 3 (n = 8 is
not a multiple of K, so proj and expand are dense: proj 24 -> 8, expand
24 -> 24, both padded to 16-multiples), and c = 16 with K = 4 (one proj
output a group)."""

import math

import pytest
import torch
import torch.nn.functional as F

from mspl_tpu_torch.layers.eesp import branch_dilations
from mspl_tpu_torch.ops import eesp_stage as es
from mspl_tpu_torch.ops.eesp_branches import _stack_plain

from tests.test_torch_encoder_kernels import _chain, _nchw

CPU = torch.device("cpu")
CASES = [(64, 4), (24, 3), (16, 4)]
BF16_ULP = 2.0 ** -7


def _units(c, k):
    x, units, _, _ = _chain(c, k, 9, (6, 10), seed=c + k)
    return _nchw(x), [es.eesp_block_params(u) for u in units]


def _mats(pk):
    """The packed bf16 blocks by name, as f32 [groups, rows, cols]."""
    return {name: pk["mma"][off:off + math.prod(shape)].view(shape).float()
            for name, off, shape in pk["blocks"]}


def _want_operands(blk):
    """The products' A operands read straight from the folded weights:
    proj group g [o, i] = pw[g*ci + i, g*co + o], expand ew transposed."""
    pw, g = blk["pw"], blk["g_proj"]
    ci, co = pw.shape[0] // g, pw.shape[1] // g
    proj = [[[pw[gi * ci + i, gi * co + o].item() for i in range(ci)]
             for o in range(co)] for gi in range(g)]
    ew = blk["ew"]
    exp = ew.transpose(1, 2) if ew.dim() == 3 else ew.t()[None]
    return {"proj": torch.tensor(proj), "expand": exp}


@pytest.mark.parametrize("c,k", CASES)
def test_packed_operands_split_and_pad(c, k):
    _, blocks = _units(c, k)
    for blk in blocks:
        pk = es._pack(blk, CPU)
        names = [name for name, _, _ in pk["blocks"]]
        assert names == ["proj_hi", "proj_lo", "expand_hi", "expand_lo"]
        end = 0
        for _, off, shape in pk["blocks"]:
            assert off % 16 == 0 and off == end
            end = off + math.prod(shape)
        assert end == pk["mma"].numel() and pk["mma"].dtype == torch.bfloat16
        # the dense proj weight has nothing outside its diagonal blocks
        g = blk["g_proj"]
        ci, co = c // g, (c // k) // g
        mask = torch.block_diag(*[torch.ones(ci, co)] * g)
        assert (blk["pw"][mask == 0] == 0).all()
        mats = _mats(pk)
        for name, want in _want_operands(blk).items():
            hi, lo = mats[f"{name}_hi"], mats[f"{name}_lo"]
            assert hi.shape[1] % 16 == 0 and hi.shape[2] % 16 == 0
            assert hi.shape == lo.shape and hi.shape[0] == want.shape[0]
            m, kk = want.shape[1:]
            got = hi[:, :m, :kk] + lo[:, :m, :kk]
            assert ((got - want).abs() <= 2.0 ** -16 * want.abs()).all(), name
            for part in (hi, lo):
                pad = part.clone()
                pad[:, :m, :kk] = 0
                assert (pad == 0).all() and not pad.signbit().any(), name


def _split(t):
    """An f32 value as the kernel splits it: bf16 hi and lo, in f32."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _product(mats, name, x, rows):
    """Group g's padded A against x's group-g channels zero-padded to the
    packed depth: lo.hi + hi.lo + hi.hi in f32; the first `rows` outputs
    of each group, concatenated."""
    a_hi, a_lo = mats[f"{name}_hi"], mats[f"{name}_lo"]
    g, _, kp = a_hi.shape
    b, c, h, w = x.shape
    xg = F.pad(x.reshape(b, g, c // g, h, w),
               (0, 0, 0, 0, 0, kp - c // g))
    x_hi, x_lo = _split(xg)
    out = sum(torch.einsum("gmk,bgkhw->bgmhw", a, t)
              for a, t in ((a_lo, x_hi), (a_hi, x_lo), (a_hi, x_hi)))
    return out[:, :, :rows].reshape(b, g * rows, h, w)


def _emulated_unit(x, blk, dilations):
    pk = es._pack(blk, CPU)
    mats = _mats(pk)
    k = len(dilations)
    c = x.shape[1]
    n = c // k
    sizes = [n, n, k * 9 * n] + [c] * 5
    pb, pa, taps, ca, cb, cal, eb, alpha = torch.split(pk["f32"], sizes)
    col = lambda v: v.view(1, -1, 1, 1)  # noqa: E731
    xf = x.float()
    y = _product(mats, "proj", xf, n // blk["g_proj"]) + col(pb)
    y = F.prelu(y, pa).to(x.dtype).float()
    z = _stack_plain(y, taps.view(k, 3, 3, n), dilations, 1)
    z = F.prelu(z * col(ca) + col(cb), cal)
    groups = mats["expand_hi"].shape[0]
    e = _product(mats, "expand", z, c // groups) + col(eb) + xf
    return F.prelu(e, alpha).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,k", CASES)
def test_split_emulation_matches_plain(c, k, dtype):
    """The kernel's arithmetic on the packed arrays against the plain
    version, with `chip_smoke.py` phase 3's tolerances: fp32 5e-4 (atol at
    the output's rms scale), bf16 (units + 1) ulps of the value and of the
    rms."""
    x, blocks = _units(c, k)
    x = x.to(dtype)
    dil = branch_dilations(k, 9)
    got = x
    for blk in blocks:
        got = _emulated_unit(got, blk, dil)
    want = es.eesp_stage_fused_eval_plain(x, blocks, dil).float()
    got = got.float()
    rms = want.pow(2).mean().sqrt().item()
    if dtype == torch.float32:
        atol, rtol = 5e-4 * max(1.0, rms), 5e-4
    else:
        tol = (len(blocks) + 1) * BF16_ULP
        atol, rtol = tol * rms, tol
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= atol + rtol * want.abs()).all()


# (C, K, r_lim, H, W): level3 and level4 of ESPNetv2 at 256x480, the
# dense K = 3 chain of chip_smoke.py, a 3x5 plane that the dilations reach
# past, level3 and level4 of a 512x1024 image (Cityscapes' size), too wide
# for a full-width row band in f32, and a 128x256 plane, too wide in bf16
# too
TILED = [(256, 4, 9, 32, 60), (512, 4, 7, 16, 30), (24, 3, 7, 16, 24),
         (16, 4, 9, 3, 5), (256, 4, 9, 64, 128), (512, 4, 7, 32, 64),
         (256, 4, 9, 128, 256)]


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,k,r_lim,h,w", TILED,
                         ids=["level3", "level4", "dense", "odd3x5",
                              "wide_level3", "wide_level4", "wide128x256"])
def test_tiling_fits_and_covers(c, k, r_lim, h, w, itemsize):
    """The tiling's shared memory fits a block, its chunks and proj
    windows are 16-pixel multiples, and its blocks (row bands of th rows,
    column bands of tw columns: the grid's x and z) cover every output
    pixel once, each block's halo band (dmax rows and columns each side,
    cut at the edges) within the staged capacity."""
    n = c // k
    grouped = c % k == 0 and n % k == 0
    g = k if grouped else 1
    dmax = max(branch_dilations(k, r_lim))
    t = es._tiling(h, w, n, c, k, dmax, itemsize, g, grouped)
    assert t.pc % 16 == 0 and t.pc >= 16
    assert t.pp % 16 == 0 and t.pp >= 16
    assert t.smem == es._smem_bytes(t.zrows, t.pc, n, t.cap, itemsize)
    assert t.smem <= es.SMEM_BYTES == 227 * 1024
    proj, exp = es._products(c, n, k, g, grouped)
    prows = proj[0] * proj[2]
    assert t.zrows >= max(prows, exp[0] * exp[2]) and t.zrows % 16 == 0
    # the staged proj window (bf16 hi, and lo for f32) fits the z region
    split = 2 if itemsize == 4 else 1
    assert prows * (t.pp + es.LD_PAD) * 2 * split <= (
        t.zrows * (t.pc + es.LD_PAD) * 4)
    assert 1 <= t.tw <= w
    covered = torch.zeros((h, w), dtype=torch.int32)
    for r0 in range(0, h, t.th):
        for c0 in range(0, w, t.tw):
            r1, c1 = min(h, r0 + t.th), min(w, c0 + t.tw)
            covered[r0:r1, c0:c1] += 1
            rows = min(h, r1 + dmax) - max(0, r0 - dmax)
            cols = min(w, c1 + dmax) - max(0, c0 - dmax)
            assert rows * cols <= t.cap
    assert bool((covered == 1).all())


@pytest.mark.parametrize("itemsize,want", [
    (2, [(16, 1200, 48, 96, 256, 227328), (16, 480, 32, 64, 512, 221184)]),
    (4, [(4, 720, 16, 16, 256, 225280), (4, 300, 16, 16, 512, 219136)]),
], ids=["bf16", "f32"])
def test_tiling_at_the_main_path_is_unchanged(itemsize, want):
    """Where a full-width row band fits, as at both of the main path's
    planes, the tiling is the full-width one the kernel has always taken
    (rows a band, capacity, chunk, proj window, z rows, shared bytes), so
    the `fuse_stages` route's launches are those measured before column
    bands came in."""
    for (c, r_lim, h, w), pinned in zip(((256, 9, 32, 60), (512, 7, 16, 30)),
                                        want):
        n = c // 4
        dmax = max(branch_dilations(4, r_lim))
        t = es._tiling(h, w, n, c, 4, dmax, itemsize, 4, True)
        assert (t.th, t.cap, t.pc, t.pp, t.zrows, t.smem) == pinned
        assert t.tw == w


def _banded_stack(y, taps, dilations, th, tw):
    """The kernel's tap phase over blocks of th x tw outputs, from each
    block's halo band of y as the kernel stages it (rows h0.., columns
    x0..x0+bw, row-major with stride bw), outputs at the kernel's
    addresses: output pixel q of a block at image row r0 + q // ow, column
    c0 + q % ow.  y [n, H, W], taps [K, 3, 3, n] -> [K*n, H, W]; every
    tap read stays in the block's halo band."""
    n, h, w = y.shape
    k, dmax = len(dilations), max(dilations)
    out = torch.full((k * n, h * w), float("nan"))
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            r1, c1 = min(h, r0 + th), min(w, c0 + tw)
            h0, h1 = max(0, r0 - dmax), min(h, r1 + dmax)
            x0 = max(0, c0 - dmax)
            bw = min(w, c1 + dmax) - x0
            ys = y[:, h0:h1, x0:x0 + bw].reshape(n, -1)
            ow = c1 - c0
            q = torch.arange((r1 - r0) * ow)
            yy, xx = r0 + q // ow, c0 + q % ow
            hff = 0.0
            for ki, d in enumerate(dilations):
                acc = 0.0
                for ky in range(3):
                    for kx in range(3):
                        sy, sx = yy + (ky - 1) * d, xx + (kx - 1) * d
                        ok = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
                        idx = (sy - h0) * bw + (sx - x0)
                        assert bool(((idx >= 0) & (idx < ys.shape[1]))[ok]
                                    .all())
                        v = ys[:, idx.clamp(0, ys.shape[1] - 1)] * ok
                        acc = acc + taps[ki, ky, kx][:, None] * v
                hff = hff + acc
                out[ki * n:(ki + 1) * n, yy * w + xx] = hff
    return out.view(k * n, h, w)


@pytest.mark.parametrize("h,w,th,tw,dil", [
    (11, 13, 3, 5, (1, 2, 3, 4)),   # column bands on an odd plane
    (16, 30, 4, 30, (1, 1, 2, 3)),  # full-width row bands
    (3, 5, 1, 2, (1, 2, 3, 4)),     # dilations past a tiny plane
    (64, 128, None, None, (1, 2, 3, 4)),  # the f32 tiling of level3
])
def test_band_layout_emulation_matches_plain(h, w, th, tw, dil):
    """The tap phase as the kernel addresses a block's halo band and its
    outputs (column bands included) gives the plain version's branch
    stack, every output written once, at tilings of odd planes and at the
    column-banded tiling `_tiling` picks for a 512x1024 image's level3 in
    f32."""
    if th is None:
        t = es._tiling(h, w, 64, 256, 4, 4, 4, 4, True)
        th, tw = t.th, t.tw
        assert tw < w
    gen = torch.Generator().manual_seed(h * w)
    n = 3
    y = torch.randn((n, h, w), generator=gen)
    taps = torch.randn((len(dil), 3, 3, n), generator=gen)
    got = _banded_stack(y, taps, dil, th, tw)
    want = _stack_plain(y[None], taps, dil, 1)[0]
    assert not bool(got.isnan().any())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
