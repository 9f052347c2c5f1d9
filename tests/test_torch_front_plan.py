"""The DownSampler front's host side (kernel 7 of the port,
`csrc/eesp_branches.cu` front_stack_kernel and front_pool_kernel) on the
CPU.

The branch kernel takes whole planes (or bands of output rows) a block,
stages each into zero-padded f32 rows of shared memory with the even and
the odd image columns in two halves, and has each thread sum a run of 8
outputs down one output column for all K branches, from taps the host
packs as [n, K*9].  The pool kernel walks strips of 8 input columns down
segments of output rows.  These tests hold the wrapper's launch plan
(`front_plan`), a plain model of both kernels' layouts built from that
plan, the launch record cache and the autograd function to the JAX
package's `down_front_pallas` (in interpret mode, and its custom VJP as
`tests/test_pallas_downsampler.py` runs it).  Inputs come from numpy
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.ops.pallas_downsampler import down_front_pallas
from mspl_tpu_torch.ops import eesp_branches as eb

SMEM_LIMIT = 227 * 1024  # shared bytes a block may take on the H100
# chip_smoke.FRONTS: (nin, n, H, W) of the three DownSamplers at 256x480
FRONTS = ((32, 24, 128, 240), (128, 32, 64, 120), (256, 64, 32, 60))


def _jax_front(x, proj, w, dilations):
    """down_front_pallas in interpret mode on NCHW numpy arrays -> NCHW
    (pool, branches)."""
    pool, br = down_front_pallas(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(proj.transpose(0, 2, 3, 1)), jnp.asarray(w), dilations,
        interpret=True)
    return (np.asarray(pool).transpose(0, 3, 1, 2),
            np.asarray(br).transpose(0, 3, 1, 2))


def _check_layout(plan, h, w, dmax):
    """The plan's shared layout holds every column the taps read in its
    own half, and rows of 16-byte words."""
    wo = (w - 1) // 2 + 1
    reach = -(-dmax // 2)
    assert plan.lpad >= reach and plan.lpad % 4 == 0 and plan.half % 4 == 0
    assert plan.half >= plan.lpad + wo + reach
    run = eb.FRONT_RUN
    assert plan.rows == 2 * -(-plan.bh // run) * run + 2 * dmax


@pytest.mark.parametrize("level,pb,bh,nbands,pool", [
    (0, 1, 8, 8, (8, 16, 4)),   # 128x240: bands of 8 output rows
    (1, 1, 24, 2, (8, 16, 4)),  # 64x120: bands of 24
    (2, 1, 16, 1, (4, 8, 2)),   # 32x60: one plane a block, 4-column strips
])
def test_plan_at_the_main_path(level, pb, bh, nbands, pool):
    """Level1's 128x240 and level2's 64x120 planes exceed FRONT_SMEM_CAP
    and take bands of 8 and 24 output rows, level3 one plane a block
    (120-360 runs of 4 outputs for a block of 128 threads), all from the
    (1,2,3,4) instance and staged with 16-byte loads; the pool takes
    strips of 8 columns,
    loads 16 bytes and stores 4 outputs at a time, but at level3, whose 60
    columns make no whole strips of 8: strips of 4, 8-byte loads, 2
    outputs a store."""
    nin, n, h, w = FRONTS[level]
    plan = eb.front_plan(128, n, h, w, (1, 2, 3, 4), 2, True, 16)
    assert (plan.sched, plan.pb, plan.bh, plan.nbands) == (0, pb, bh, nbands)
    assert (plan.pool_strip, plan.pool_load, plan.pool_store) == pool
    assert plan.vec
    _check_layout(plan, h, w, 4)
    assert plan.smem == 4 * (-(-plan.pb * 36 // 4) * 4
                             + plan.pb * plan.rows * 2 * plan.half)
    assert plan.smem <= eb.FRONT_SMEM_CAP <= SMEM_LIMIT
    runs = plan.pb * -(-plan.bh // eb.FRONT_RUN) * ((w - 1) // 2 + 1)
    assert 0.9 * eb.FRONT_THREADS <= runs <= 4 * eb.FRONT_THREADS


@pytest.mark.parametrize("shape,dil,itemsize,aligned,x_align,want", [
    ((2, 4, 37, 53), (1, 2, 3, 4), 2, True, 16, (0, False, 8, 0, 1)),
    ((2, 3, 13, 21), (2, 2), 4, True, 16, (1, False, 8, 0, 1)),
    ((2, 5, 17, 30), (1, 2, 4), 2, True, 16, (1, False, 8, 0, 1)),
    ((2, 4, 24, 36), (1, 2, 4, 8), 4, True, 16, (1, True, 4, 16, 2)),
    ((2, 4, 32, 60), (1, 2, 3, 4), 2, False, 2, (0, False, 4, 0, 2)),
    ((2, 4, 32, 60), (1, 2, 3, 4), 4, True, 8, (0, True, 4, 8, 2)),
])
def test_plan_at_odd_shapes(shape, dil, itemsize, aligned, x_align, want):
    """Dilations other than (1,2,3,4) take the run-time instance; 16-byte
    staging only where every plane starts on a word; the pool's strips of
    4 columns where W is a multiple of 4 but not of 8, its loads as wide
    as the rows' words, x's address and a strip allow (0: element by
    element), its stores as wide as Wo and half a strip allow."""
    b, n, h, w = shape
    plan = eb.front_plan(b, n, h, w, dil, itemsize, aligned, x_align)
    assert (plan.sched, plan.vec, plan.pool_strip, plan.pool_load,
            plan.pool_store) == want
    _check_layout(plan, h, w, max(dil))
    assert 1 <= plan.pb <= b * n and plan.smem <= eb.FRONT_SMEM_CAP


@pytest.mark.parametrize("h,w", [(300, 260), (128, 240), (256, 512),
                                 (257, 1023)])
def test_plan_bands_cover_every_output_row_once(h, w):
    """A plane beyond FRONT_SMEM_CAP is cut into bands of whole runs, one
    band a block, within FRONT_SMEM_CAP, or bands of one run up to a
    block's whole shared memory where not even that fits (a 512x1024
    image's first DownSampler takes 256x512): the bands cover every output
    row once, and a band's shared rows hold every image row its runs read.
    A plane too wide for one run's rows in a block raises."""
    dmax = 4
    plan = eb.front_plan(1, 2, h, w, (1, 2, 3, 4), 2, True, 16)
    ho = (h - 1) // 2 + 1
    assert plan.nbands > 1 and plan.pb == 1 and plan.bh % eb.FRONT_RUN == 0
    assert plan.smem <= (eb.FRONT_SMEM_CAP if plan.bh > eb.FRONT_RUN
                         else SMEM_LIMIT)
    covered = []
    for band in range(plan.nbands):
        oy0 = band * plan.bh
        oy1 = min(ho, oy0 + plan.bh)
        covered += range(oy0, oy1)
        # the last run's last output row reads image row 2*oy + dmax, at
        # shared row y - (2*oy0 - dmax)
        runs_end = oy0 + -(-(oy1 - oy0) // eb.FRONT_RUN) * eb.FRONT_RUN
        assert 2 * (runs_end - 1) + dmax - (2 * oy0 - dmax) < plan.rows
    assert covered == list(range(ho))
    with pytest.raises(ValueError, match="kernel limit"):
        eb.front_plan(1, 1, 64, 8000, (1, 2, 3, 4), 4, True, 16)


def _stack_model(proj, taps, dilations):
    """The branch kernel's arithmetic as the plan lays it out: per band of
    each plane, the shared rows with even and odd columns in two halves
    (zero where nothing is staged), a run of FRONT_RUN outputs down each output
    column, each tap read from the half and the word the kernel computes
    (image column 2*ox + dx at half (dx & 1), word lpad + ox + (dx >> 1)),
    the HFF sums kept in f32.  Asserts that every read stays in its half
    and in the band's rows.  proj [B, n, H, W] torch f32, taps packed."""
    b, n, h, w = proj.shape
    k, dmax = len(dilations), max(dilations)
    plan = eb.front_plan(b, n, h, w, dilations, 4, False, 4)
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = torch.zeros((b, k * n, ho, wo))
    xs = torch.arange(w)
    cols = (xs % 2) * plan.half + plan.lpad + xs // 2
    ox = torch.arange(wo)
    for band in range(plan.nbands):
        oy0 = band * plan.bh
        oy1 = min(ho, oy0 + plan.bh)
        row0 = dmax - 2 * oy0
        ya, yb = max(0, 2 * oy0 - dmax), min(h, 2 * oy1 - 1 + dmax)
        smem = torch.zeros((b, n, plan.rows, 2 * plan.half))
        ys = torch.arange(ya, yb)
        smem[:, :, (ys + row0)[:, None], cols[None, :]] = proj[:, :, ya:yb]
        nry = -(-(oy1 - oy0) // eb.FRONT_RUN)
        cen = 2 * (oy0 + torch.arange(nry * eb.FRONT_RUN)) + row0
        hff = 0.0
        for ki, d in enumerate(dilations):
            acc = 0.0
            for kx in range(3):
                dx = (kx - 1) * d
                half = plan.half if dx & 1 else 0
                col = plan.lpad + ox + half + (dx >> 1)
                assert half <= col.min() and col.max() < half + plan.half
                for ky in range(3):
                    r = cen + (ky - 1) * d
                    assert r.min() >= 0 and r.max() < plan.rows
                    t = taps[:, ki * 9 + ky * 3 + kx].view(1, n, 1, 1)
                    acc = acc + t * smem[:, :, r[:, None], col[None, :]]
            hff = hff + acc
            out[:, ki * n:(ki + 1) * n, oy0:oy1] = hff[:, :, :oy1 - oy0]
    return out


def _pool_model(x):
    """The pool kernel's walk: each segment of POOL_SEG output rows starts
    from the horizontal 3-sums of image row 2*oy0 - 1, then per output row
    adds those of rows 2*oy and 2*oy + 1 (each read once, the second kept
    for the next row) and divides by 9; columns past the image and rows
    outside it are 0."""
    b, c, h, w = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = torch.zeros((b, c, h, 2 * wo + 1))
    xp[..., 1:w + 1] = x  # column j at j + 1; column -1 at 0

    def hsum(y):
        if not 0 <= y < h:
            return torch.zeros((b, c, wo))
        row = xp[:, :, y]
        return row[..., 0:2 * wo:2] + row[..., 1:2 * wo + 1:2] + row[
            ..., 2:2 * wo + 2:2]

    out = torch.zeros((b, c, ho, wo))
    for oy0 in range(0, ho, eb.POOL_SEG):
        hp = hsum(2 * oy0 - 1)
        for oy in range(oy0, min(ho, oy0 + eb.POOL_SEG)):
            h0, h1 = hsum(2 * oy), hsum(2 * oy + 1)
            out[:, :, oy] = (hp + h0 + h1) / 9.0
            hp = h1
    return out


@pytest.mark.parametrize("dilations", [(1, 2, 3, 4), (2, 2), (1, 2, 4),
                                       (1, 2, 4, 8)],
                         ids=["fixed", "d22", "k3", "jax_tests"])
@pytest.mark.parametrize("hw", [(13, 21), (32, 60), (36, 24)])
def test_kernel_model_matches_pallas(dilations, hw):
    """The plan's layouts give the JAX kernel's pool and branch stack at
    odd planes (13x21) and level3's 32x60, within fp32's atol 1e-5 + rtol
    1e-5; so does the plain version fed the packed taps."""
    rng = np.random.default_rng(sum(dilations) * 5 + hw[0])
    nin, n = 5, 4
    x = rng.normal(size=(2, nin, *hw)).astype(np.float32)
    proj = rng.normal(size=(2, n, *hw)).astype(np.float32)
    w = (rng.normal(size=(len(dilations), 3, 3, n)) * 0.3).astype(np.float32)
    want_pool, want_br = _jax_front(x, proj, w, dilations)
    taps = eb.pack_taps(torch.from_numpy(w))
    got_br = _stack_model(torch.from_numpy(proj), taps, dilations)
    got_pool = _pool_model(torch.from_numpy(x))
    np.testing.assert_allclose(got_br.numpy(), want_br, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_pool.numpy(), want_pool, rtol=1e-5,
                               atol=1e-5)
    pool, br = eb.down_front(torch.from_numpy(x), torch.from_numpy(proj),
                             taps, dilations)
    np.testing.assert_allclose(br.numpy(), want_br, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pool.numpy(), want_pool, rtol=1e-5, atol=1e-5)
    assert eb.down_front.launches == 0


def test_kernel_model_in_bands_matches_pallas(monkeypatch):
    """With a shared-memory cap that cuts the 52x40 plane's 26 output rows
    into bands of 8 (the last one 2 rows), the banded layout gives the same
    stack, and the pool's segments of 16 rows (the last one 10) the same
    pool."""
    monkeypatch.setattr(eb, "FRONT_SMEM_CAP", 6 * 1024)
    plan = eb.front_plan(2, 3, 52, 40, (1, 2, 3, 4), 4, False, 4)
    assert plan.nbands == 4 and plan.bh == 8
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 2, 52, 40)).astype(np.float32)
    proj = rng.normal(size=(2, 3, 52, 40)).astype(np.float32)
    w = (rng.normal(size=(4, 3, 3, 3)) * 0.3).astype(np.float32)
    want_pool, want_br = _jax_front(x, proj, w, (1, 2, 3, 4))
    got = _stack_model(torch.from_numpy(proj), eb.pack_taps(
        torch.from_numpy(w)), (1, 2, 3, 4))
    np.testing.assert_allclose(got.numpy(), want_br, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_pool_model(torch.from_numpy(x)).numpy(),
                               want_pool, rtol=1e-5, atol=1e-5)


def test_launch_record_is_built_once_a_shape():
    """A batch issues 9 front calls: each shape's launch arguments (dtype
    code, shape, dilations as a ctypes array, the plan's fields) are built
    once and reused."""
    eb._front_record.cache_clear()
    args = (128, 24, 32, 128, 240, (1, 2, 3, 4), 2, True, 16)
    first = eb._front_record(*args)
    assert eb._front_record(*args) is first
    assert eb._front_record.cache_info().hits == 1
    plan = eb.front_plan(128, 24, 128, 240, (1, 2, 3, 4), 2, True, 16)
    assert first[:7] == (1, 128, 24, 32, 128, 240, 4)
    assert list(first[7]) == [1, 2, 3, 4]
    assert first[8:] == (plan.sched, plan.pb, plan.bh, plan.lpad, plan.half,
                         plan.rows, int(plan.vec), plan.smem,
                         plan.pool_strip, plan.pool_load, plan.pool_store)
    with pytest.raises(ValueError, match="kernel limit"):
        eb._front_record(1, 1, 1, 8, 8, tuple(range(1, 10)), 4, True, 16)


def _grads(fn, x, proj, taps, dilations, g_pool, g_br):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, proj, taps)]
    pool, br = fn(*leaves, dilations)
    loss = (pool * torch.from_numpy(g_pool)).sum() + (
        br * torch.from_numpy(g_br)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("dilations", [(1, 2, 4, 8), (1, 2, 3, 4)])
def test_plain_gradients_match_jax_vjp(dilations):
    """The plain version's gradients of x, proj and the taps (autograd on
    the CPU) against the JAX kernel's custom VJP (`jax.vjp` of its lax
    reference), run as tests/test_pallas_downsampler.py runs it, at the
    JAX test's rtol/atol 1e-4; the taps' gradient comes back packed."""
    rng = np.random.default_rng(len(dilations) + max(dilations))
    b, h, w, nin, n = 1, 12, 16, 4, 4
    x = rng.normal(size=(b, nin, h, w)).astype(np.float32)
    proj = rng.normal(size=(b, n, h, w)).astype(np.float32)
    wk = (rng.normal(size=(len(dilations), 3, 3, n)) * 0.3).astype(np.float32)
    h2, w2 = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    g_pool = rng.normal(size=(b, nin, h2, w2)).astype(np.float32)
    g_br = rng.normal(size=(b, len(dilations) * n, h2, w2)).astype(np.float32)

    def loss(xa, pa, wa):
        pool, br = down_front_pallas(xa, pa, wa, dilations)
        return (jnp.sum(pool * g_pool.transpose(0, 2, 3, 1))
                + jnp.sum(br * g_br.transpose(0, 2, 3, 1)))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(proj.transpose(0, 2, 3, 1)), jnp.asarray(wk))
    taps = eb.pack_taps(torch.from_numpy(wk)).numpy()
    got = _grads(eb.down_front_plain, x, proj, taps, dilations, g_pool, g_br)
    np.testing.assert_allclose(got[0], np.asarray(want[0]).transpose(
        0, 3, 1, 2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], np.asarray(want[1]).transpose(
        0, 3, 1, 2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2], eb.pack_taps(torch.tensor(
        np.asarray(want[2]))).numpy(), rtol=1e-4, atol=1e-4)


def test_autograd_function_backward_is_the_plain_vjp(monkeypatch):
    """`_DownFront` (the kernels' forward, the plain version's VJP
    backward) with its launch stood in by the plain version on the CPU:
    its gradients of x, proj and the taps equal autograd through the
    plain version, and an input that needs no gradient gets none."""
    monkeypatch.setattr(eb, "_launch_front", eb.down_front_plain)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 13, 21)).astype(np.float32)
    proj = rng.normal(size=(2, 4, 13, 21)).astype(np.float32)
    taps = rng.normal(size=(4, 27)).astype(np.float32)
    g_pool = rng.normal(size=(2, 3, 7, 11)).astype(np.float32)
    g_br = rng.normal(size=(2, 12, 7, 11)).astype(np.float32)
    fn = lambda a, p, t, d: eb._DownFront.apply(a, p, t, d)  # noqa: E731
    got = _grads(fn, x, proj, taps, (1, 2, 4), g_pool, g_br)
    want = _grads(eb.down_front_plain, x, proj, taps, (1, 2, 4), g_pool,
                  g_br)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    xt = torch.from_numpy(x)
    pt = torch.from_numpy(proj).requires_grad_()
    pool, br = eb._DownFront.apply(xt, pt, torch.from_numpy(taps), (1, 2, 4))
    (g,) = torch.autograd.grad(br.sum(), [pt])
    assert g.shape == pt.shape and xt.grad is None
