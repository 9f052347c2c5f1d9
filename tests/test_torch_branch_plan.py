"""The stride-1 EESP branch kernel's host side (kernel 5 of the port,
`csrc/eesp_branches.cu` eesp_stack_kernel) on the CPU.

The kernel takes whole planes a block, stages each into zero-padded f32
rows of shared memory, and has each thread sum a run of 8 outputs down one
column for all K branches, from taps the host packs as [n, K*9].  These
tests hold the packing and its per-unit cache, the wrapper's launch plan
(`stack_plan`), and a plain model of the kernel's layout built from that
plan, to the JAX package's `eesp_branches_pallas` in interpret mode.
Inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.ops.pallas_eesp import eesp_branches_pallas
from mspl_tpu_torch.layers.eesp import EESP
from mspl_tpu_torch.ops import eesp_branches as eb

SMEM_LIMIT = 227 * 1024  # shared bytes a block may take on the H100


def test_pack_taps_layout():
    """Channel c's taps are contiguous, tap k*9 + ky*3 + kx."""
    w = np.random.default_rng(0).normal(size=(3, 3, 3, 5)).astype(np.float32)
    packed = eb.pack_taps(torch.from_numpy(w)).numpy()
    assert packed.shape == (5, 27) and packed.dtype == np.float32
    for k in range(3):
        for ky in range(3):
            for kx in range(3):
                np.testing.assert_array_equal(packed[:, k * 9 + ky * 3 + kx],
                                              w[k, ky, kx])
    # the plain version reads branch k's kernel as packed[:, 9k:9k + 9]
    np.testing.assert_array_equal(
        packed.reshape(5, 3, 3, 3).transpose(1, 2, 3, 0), w)


def test_branch_taps_cache_follows_weight_swaps():
    """The route's packed taps are cached on the unit; an in-place load of
    new weights (as load_flax_variables or set_variables does) repacks
    them, and the parameter tree holds no trace of the cache."""
    torch.manual_seed(0)
    unit = EESP(32, 32, k=4, r_lim=9, use_pallas=True).eval()
    first = unit.branch_taps()
    assert unit.branch_taps() is first
    want = eb.pack_taps(torch.stack([wk[:, 0] for wk in unit.dw])
                        .permute(0, 2, 3, 1))
    torch.testing.assert_close(first, want, rtol=0, atol=0)
    new = torch.randn_like(unit.dw[2])
    with torch.no_grad():
        unit.dw[2].copy_(new)
    swapped = unit.branch_taps()
    assert swapped is not first
    torch.testing.assert_close(swapped[:, 18:27],
                               new[:, 0].reshape(8, 9), rtol=0, atol=0)
    assert not any("packed" in k for k in unit.state_dict())
    with torch.inference_mode():
        unit.dw[0].data = unit.dw[0].data.clone()  # a new storage
        assert unit.branch_taps() is not swapped
    assert not unit.branch_taps().is_inference()


@pytest.mark.parametrize("shape,dil,pb,sched", [
    ((128, 64, 32, 60), (1, 2, 3, 4), 1, 0),   # level3
    ((128, 128, 16, 30), (1, 1, 2, 3), 2, 1),  # level4
])
def test_plan_at_the_main_path(shape, dil, pb, sched):
    """Level3 takes one 32x60 plane a block, level4 two 16x30 planes: ~120
    runs of 8 outputs for a block of 128 threads, each run 32 outputs (8
    rows x 4 branches), from the template instance of its schedule,
    staged with 16-byte loads, within the shared memory of a block."""
    b, n, h, w = shape
    plan = eb.stack_plan(b, n, h, w, dil, 2, True)
    assert (plan.sched, plan.pb, plan.nbands, plan.bh) == (sched, pb, 1, h)
    assert plan.outputs_per_run == 32 and plan.vec
    runs = plan.pb * -(-h // eb.RUN) * w
    assert 0.9 * eb.THREADS <= runs <= 2 * eb.THREADS
    assert plan.lpad >= max(dil) and plan.sw >= plan.lpad + w + max(dil)
    assert plan.lpad % 4 == 0 and plan.sw % 4 == 0  # 16-byte rows
    assert plan.rows == h + 2 * max(dil)
    assert plan.smem == 4 * (-(-plan.pb * 36 // 4) * 4
                             + plan.pb * plan.rows * plan.sw)
    assert plan.smem <= eb.SMEM_CAP <= SMEM_LIMIT


@pytest.mark.parametrize("shape,dil,itemsize,aligned,vec", [
    ((2, 8, 11, 13), (2, 2), 4, True, False),      # 143 pixels: no word
    ((2, 8, 11, 13), (1, 2, 4), 2, True, False),
    ((3, 5, 16, 30), (1, 2, 3, 4), 2, False, False),
    ((3, 5, 16, 30), (1, 2, 3, 4), 4, True, True),
    ((1, 3, 7, 5), (1, 2, 3, 4, 5, 6, 7, 8), 4, True, False),
])
def test_plan_at_odd_shapes(shape, dil, itemsize, aligned, vec):
    """Dilations off the model's schedules take the run-time instance;
    16-byte staging only where every plane starts on a word."""
    b, n, h, w = shape
    plan = eb.stack_plan(b, n, h, w, dil, itemsize, aligned)
    want_sched = (eb.SCHEDULES.index(dil) if dil in eb.SCHEDULES
                  else len(eb.SCHEDULES))
    assert plan.sched == want_sched and plan.vec == vec
    assert plan.outputs_per_run == eb.RUN * len(dil)
    assert 1 <= plan.pb <= b * n and plan.smem <= eb.SMEM_CAP


def test_plan_bands_a_plane_too_large_for_a_block():
    """A plane beyond SMEM_CAP is cut into bands of whole 8-row runs, one
    band a block; a plane too wide for one run's rows raises."""
    plan = eb.stack_plan(1, 4, 300, 400, (1, 2, 3, 4), 2, True)
    assert plan.nbands == -(-300 // plan.bh) > 1 and plan.pb == 1
    assert plan.bh % eb.RUN == 0 and plan.smem <= eb.SMEM_CAP
    with pytest.raises(ValueError, match="kernel limit"):
        eb.stack_plan(1, 1, 64, 4000, (1, 2, 3, 4), 4, True)


def _kernel_model(proj, weights, dilations):
    """The stride-1 kernel's arithmetic as the plan lays it out: per band
    of each plane, the zero-padded f32 rows of shared memory, a run of
    RUN outputs down each column, each branch's 9 taps summed in f32 in
    the order of the template instances (column offset, then row), the
    HFF sums added branch by branch and kept in f32 (the fp32 case rounds
    nothing).  proj [B, n, H, W], weights [K, 3, 3, n], numpy f32."""
    b, n, h, w = proj.shape
    k, dmax = len(dilations), max(dilations)
    plan = eb.stack_plan(b, n, h, w, dilations, 4, False)
    taps = eb.pack_taps(torch.from_numpy(weights)).numpy()  # [n, K*9]
    out = np.zeros((b, k * n, h, w), np.float32)
    planes = proj.reshape(b * n, h, w)
    tp = np.tile(taps, (b, 1))  # plane b*n + c takes channel c's taps
    for band in range(plan.nbands):
        y0 = band * plan.bh
        y1 = min(h, y0 + plan.bh)
        ya, yb = max(0, y0 - dmax), min(h, y1 + dmax)
        smem = np.zeros((b * n, plan.rows, plan.sw), np.float32)
        smem[:, ya - y0 + dmax:yb - y0 + dmax, plan.lpad:plan.lpad + w] = \
            planes[:, ya:yb]
        for yo in range(y0, y1, eb.RUN):
            nv = min(eb.RUN, y1 - yo)
            r0 = yo - y0 + dmax
            hff = np.zeros((b * n, eb.RUN, w), np.float32)
            for ki, d in enumerate(dilations):
                acc = np.zeros_like(hff)
                for dx in range(-dmax, dmax + 1):
                    if dx not in (0, d, -d):
                        continue
                    kx = 1 if dx == 0 else (0 if dx < 0 else 2)
                    c0 = plan.lpad + dx
                    for ky in range(3):
                        r = r0 + (ky - 1) * d
                        t = tp[:, ki * 9 + ky * 3 + kx][:, None, None]
                        acc = acc + t * smem[:, r:r + eb.RUN, c0:c0 + w]
                hff = hff + acc
                o = hff[:, :nv].reshape(b, n, nv, w)
                out[:, ki * n:(ki + 1) * n, yo:yo + nv] = o
    return out


@pytest.mark.parametrize("dilations", [(1, 2, 3, 4), (1, 1, 2, 3), (2, 2),
                                       (1, 2, 4)],
                         ids=["level3", "level4", "d22", "k3"])
@pytest.mark.parametrize("hw", [(11, 13), (16, 30), (21, 9)])
def test_kernel_model_matches_pallas(dilations, hw):
    """The plan's layout gives the JAX kernel's branch stack, at planes
    whose pixel counts are not multiples of 8 (11x13, 21x9) and at level4's
    16x30, within fp32's atol 1e-5 + rtol 1e-5; so does the plain version
    fed the packed taps."""
    rng = np.random.default_rng(sum(dilations) * 7 + hw[0])
    n = 6
    x = rng.normal(size=(2, n, *hw)).astype(np.float32)
    w = rng.normal(size=(len(dilations), 3, 3, n)).astype(np.float32)
    want = np.asarray(eesp_branches_pallas(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w), dilations,
        interpret=True)).transpose(0, 3, 1, 2)
    got = _kernel_model(x, w, dilations)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = eb.eesp_branches(torch.from_numpy(x),
                             eb.pack_taps(torch.from_numpy(w)), dilations)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)
    assert eb.eesp_branches.launches == 0


def test_kernel_model_in_bands_matches_pallas(monkeypatch):
    """With a shared-memory cap that cuts the 26x40 plane into bands of 8
    rows (the last one 2 rows), the banded layout gives the same stack."""
    monkeypatch.setattr(eb, "SMEM_CAP", 4 * 1024)
    plan = eb.stack_plan(2, 3, 26, 40, (1, 2, 3, 4), 4, False)
    assert plan.nbands == 4 and plan.bh == 8
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 3, 26, 40)).astype(np.float32)
    w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    want = np.asarray(eesp_branches_pallas(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w), (1, 2, 3, 4),
        interpret=True)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(_kernel_model(x, w, (1, 2, 3, 4)), want,
                               rtol=1e-5, atol=1e-5)


def test_launch_record_is_built_once_a_shape():
    """A forward issues 30 calls: each shape's launch arguments (dtype code,
    shape, dilations as a ctypes array, the plan's fields) are built once
    and reused."""
    eb._stack_record.cache_clear()
    first = eb._stack_record(128, 64, 32, 60, (1, 2, 3, 4), 2, True)
    assert eb._stack_record(128, 64, 32, 60, (1, 2, 3, 4), 2, True) is first
    assert eb._stack_record.cache_info().hits == 1
    plan = eb.stack_plan(128, 64, 32, 60, (1, 2, 3, 4), 2, True)
    assert first[:6] == (1, 128, 64, 32, 60, 4)
    assert list(first[6]) == [1, 2, 3, 4]
    assert first[7:] == (plan.sched, plan.pb, plan.bh, plan.lpad, plan.sw,
                         plan.rows, int(plan.vec), plan.smem)
    with pytest.raises(ValueError, match="kernel limit"):
        eb._stack_record(1, 1, 8, 8, tuple(range(1, 10)), 4, True)
