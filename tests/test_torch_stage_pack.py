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


# (C, K, H, W, grouped): level3 and level4 of ESPNetv2 at 256x480, the
# dense K = 3 chain of chip_smoke.py, and a 3x5 plane that the dilations
# reach past
TILED = [(256, 4, 9, 32, 60), (512, 4, 7, 16, 30), (24, 3, 7, 16, 24),
         (16, 4, 9, 3, 5)]


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,k,r_lim,h,w", TILED,
                         ids=["level3", "level4", "dense", "odd3x5"])
def test_tiling_fits_and_covers(c, k, r_lim, h, w, itemsize):
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
    covered = []
    for r0 in range(0, h, t.th):   # one block a band, grid ceil(h / th)
        r1 = min(h, r0 + t.th)
        covered += range(r0, r1)
        halo = min(h, r1 + dmax) - max(0, r0 - dmax)
        assert halo * w <= t.cap
    assert covered == list(range(h))
