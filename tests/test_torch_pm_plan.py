"""The launch plan of the pixel-major fused pseudo-label kernel (kernel 8 of
the port, `csrc/pseudo_pm.cu`) on the CPU.

A warp of the kernel copies a run of 128 consecutive pixels of each model,
128 x C_m contiguous values, into its own stage in shared memory, and lane
l takes pixels l, l + 32, l + 64 and l + 96 of the run.  These tests hold
the wrapper's plan (`pm_plan`: each model's place in the stage, the warps
a block, the tables' instance, the copy path), and a plain model of the
4-pixel runs built from that plan, to the JAX package's
`fused_pseudo_pass_pallas` in interpret mode.  Inputs come from numpy
seeds."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data.label_space import label_conversion_matrix
from mspl_tpu.ops.pallas_pseudo import fused_pseudo_pass_pallas
from mspl_tpu.pseudo.generate import fused_pseudo_pass
from mspl_tpu_torch.ops import pseudo
from mspl_tpu_torch.ops.pseudo import (MAX_WARPS, PIXELS_PER_LANE,
                                       RUN_PIXELS, STAGE_CAP, pm_plan)

SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))
SMEM_LIMIT = 227 * 1024  # shared bytes a block may take on the H100


def test_plan_at_the_main_path():
    """Three bf16 sources (11, 19, 5 channels) take a stage of 35 x 128 x 2
    bytes a warp, 4 warps a block, the 4-column tables for T + 1 = 4, and
    16-byte copies when the logits sit on their words."""
    plan = pm_plan([c for _, c in SOURCES], [2, 2, 2], 3, True)
    assert plan.offsets == (0, 11 * 256, 30 * 256)
    assert plan.wbytes == 35 * 256 and plan.warps == MAX_WARPS
    assert plan.t1 == 4 and plan.vec
    assert RUN_PIXELS == 32 * PIXELS_PER_LANE == 128


@pytest.mark.parametrize("aligned", [True, False])
def test_plan_copy_path(aligned):
    """The vector path depends on the tensors' words alone: a run starts
    128 x C_m x size bytes into a tensor, a multiple of 16, whatever the
    pixel count (the plan never sees it); a run past the last pixel copies
    what is there."""
    plan = pm_plan([11, 19, 5, 3], [2, 2, 2, 4], 3, aligned)
    assert plan.vec == aligned
    for off, c, size in zip(plan.offsets, [11, 19, 5, 3], [2, 2, 2, 4]):
        assert off % 16 == 0 and (RUN_PIXELS * c * size) % 16 == 0
    assert plan.wbytes == 35 * 256 + 3 * 512


@pytest.mark.parametrize("channels,sizes,n_t,t1", [
    ([32] * 4, [4] * 4, 7, 8),
    ([1], [2], 3, 4),
    ([7, 13], [4, 2], 4, 8),
    ([3], [4], 1, 4),
    ([19, 5], [4, 4], 3, 4),
    ([19, 19, 5, 3], [2, 2, 2, 2], 3, 4),
])
def test_plan_widths_and_warps(channels, sizes, n_t, t1):
    """Each model's run takes 128 x C_m values rounded up to 16 bytes, in
    model order; the warps a block shrink so that the stages keep within
    STAGE_CAP (the block's shared memory within the card's), never below
    one; the tables take the 4-column instance for T + 1 <= 4."""
    plan = pm_plan(channels, sizes, n_t, True)
    ends = [off + RUN_PIXELS * c * s for off, c, s in
            zip(plan.offsets, channels, sizes)]
    assert list(plan.offsets[1:]) == [-(-e // 16) * 16 for e in ends[:-1]]
    assert plan.wbytes == -(-ends[-1] // 16) * 16
    assert 1 <= plan.warps <= MAX_WARPS and plan.t1 == t1
    assert plan.warps * plan.wbytes <= max(STAGE_CAP, plan.wbytes)
    assert plan.warps * plan.wbytes + _static_bytes(t1) <= SMEM_LIMIT


def _static_bytes(t1):
    """The kernel's static shared memory: the tables of MAX_MODELS models
    of MAX_C channels padded to t1 columns, and kc (MAX_T1 floats)."""
    return 4 * (pseudo.MAX_MODELS * pseudo.MAX_C * t1 + pseudo.MAX_T1)


@pytest.mark.parametrize("channels,sizes", [
    ([19, 5], [4, 4]),
    ([19, 19, 5, 3], [2, 2, 2, 2]),
])
def test_plan_past_the_default_shared_limit(channels, sizes):
    """Ensembles whose stages take 45-48 KB a block: with the static tables
    beside them a block passes the 48 KB that a launch gets without opting
    in, so the kernel's launch always opts in to the plan's dynamic bytes
    (chip_smoke.py checks both ensembles on the card)."""
    plan = pm_plan(channels, sizes, 3, True)
    dynamic = plan.warps * plan.wbytes
    assert 45 * 1024 <= dynamic <= 48 * 1024 and plan.warps == MAX_WARPS
    assert dynamic + _static_bytes(plan.t1) > 48 * 1024
    assert dynamic + _static_bytes(plan.t1) <= SMEM_LIMIT


def _xlogx(p):
    return torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-30)),
                       torch.zeros_like(p))


def _run_model(logits, convs, mode, conf_mode, kc):
    """The pass as the plan lays it out: the pixels cut into runs of 128
    (zero past the last), lane l's 4 pixels at l + 32 j, each model's max,
    exp(x - max) summed into the tables padded to T1 columns, one
    reciprocal; soft: the T+1 columns averaged, first argmax over T, the
    max or the entropy of all T+1; hard: each model's first argmax over
    T+1 votes over T, min_agree a strict majority."""
    n_t = convs[0].shape[1] - 1
    shape = logits[0].shape[:3]
    total = int(np.prod(shape))
    plan = pm_plan([x.shape[3] for x in logits],
                   [x.itemsize for x in logits], n_t, False)
    runs = -(-total // RUN_PIXELS)
    n = len(logits)
    acc = torch.zeros((runs, PIXELS_PER_LANE, 32, plan.t1))
    for x, conv in zip(logits, convs):
        c = x.shape[3]
        flat = torch.zeros((runs * RUN_PIXELS, c))
        flat[:total] = torch.from_numpy(x.reshape(total, c))
        v = flat.reshape(runs, PIXELS_PER_LANE, 32, c)  # [run, j, lane, c]
        e = torch.exp(v - v.amax(dim=-1, keepdim=True))
        tab = torch.zeros((c, plan.t1))
        tab[:, :n_t + 1] = torch.from_numpy(conv)
        q = (e @ tab) * (1.0 / e.sum(dim=-1, keepdim=True))
        if mode == "hard":
            lab = q[..., :n_t + 1].argmax(dim=-1)
            acc[..., :n_t] += torch.nn.functional.one_hot(
                lab, n_t + 1)[..., :n_t].float()
        else:
            acc[..., :n_t + 1] += q[..., :n_t + 1]
    acc = acc.reshape(runs * RUN_PIXELS, plan.t1)[:total]
    inv_n, inv_log = 1.0 / n, 1.0 / math.log(n_t + 1)
    if mode == "hard":
        top, lbl = acc[:, :n_t].max(dim=1)
        if conf_mode == "entropy":
            tot = acc[:, :n_t].sum(dim=1)
            s = _xlogx(acc[:, :n_t] * inv_n).sum(dim=1)
            conf = 1.0 + (s + _xlogx((n - tot) * inv_n)) * inv_log
        else:
            conf = top * inv_n
        lbl = torch.where(top >= n // 2 + 1, lbl, torch.full_like(lbl, 255))
    else:
        f = acc * inv_n
        best, lbl = f[:, :n_t].max(dim=1)
        conf = (1.0 + _xlogx(f[:, :n_t + 1]).sum(dim=1) * inv_log
                if conf_mode == "entropy" else best)
    if kc is not None:
        k = torch.from_numpy(kc)
        thr = k[torch.where(lbl == 255, 0, lbl)]
        lbl = torch.where(conf >= thr, lbl, torch.full_like(lbl, 255))
    return lbl.reshape(shape).to(torch.int32), conf.reshape(shape)


@pytest.mark.parametrize("with_kc", [False, True])
@pytest.mark.parametrize("mode,conf_mode", [("soft", "prob"),
                                            ("soft", "entropy"),
                                            ("hard", "prob"),
                                            ("hard", "entropy")])
def test_run_model_matches_pallas(mode, conf_mode, with_kc):
    """At batch 3 and 17 x 29 pixels (1479: 11 runs of 128 and a part,
    not a multiple of 4) the plan's runs give the JAX kernel's labels
    exactly and its confidences within 1e-5; so does the port's plain
    version, which the wrapper takes on the CPU."""
    rng = np.random.default_rng(41)
    logits = [rng.normal(0, 2, (3, 17, 29, c)).astype(np.float32)
              for _, c in SOURCES]
    convs = [label_conversion_matrix(n) for n, _ in SOURCES]
    kc = np.asarray([0.4, 0.5, 0.6], np.float32) if with_kc else None
    want_l, want_c = fused_pseudo_pass_pallas(
        [jnp.asarray(x) for x in logits], convs, mode=mode,
        kc=None if kc is None else jnp.asarray(kc), conf_mode=conf_mode,
        interpret=True)
    got_l, got_c = _run_model(logits, convs, mode, conf_mode, kc)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
    plain_l, plain_c = pseudo.fused_pseudo_pass_pm(
        [torch.from_numpy(x) for x in logits], convs, mode=mode,
        kc=None if kc is None else torch.from_numpy(kc), conf_mode=conf_mode)
    np.testing.assert_array_equal(plain_l.numpy(), got_l.numpy())
    np.testing.assert_allclose(plain_c.numpy(), got_c.numpy(), rtol=0,
                               atol=1e-5)
    assert pseudo.fused_pseudo_pass_pm.launches == 0


@pytest.mark.parametrize("channels,sizes,warps", [
    ([11, 19, 5, 11, 3], [2, 2, 2, 2, 4], MAX_WARPS),
    ([11, 19, 5, 11, 19, 5, 11, 19], [4] * 8, 1),
    ([32] * 8, [4] * 8, 1),
])
def test_plan_at_5_and_8_models(channels, sizes, warps):
    """Past the main path's 3 models, up to the kernel's 8: a round's 5
    (4 bf16 sources and the f32 target model) keeps 4 warps a block; 8
    f32 models stage 50-128 KB a warp, so the plan drops to one warp a
    block, which with the static tables of 8 models still fits the
    card's shared memory."""
    plan = pm_plan(channels, sizes, 3, True)
    assert len(plan.offsets) == len(channels) <= pseudo.MAX_MODELS == 8
    assert plan.warps == warps
    assert plan.wbytes == sum(-(-RUN_PIXELS * c * s // 16) * 16
                              for c, s in zip(channels, sizes))
    assert plan.warps * plan.wbytes + _static_bytes(plan.t1) <= SMEM_LIMIT


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_plain_matches_jax_at_5_models(mode):
    """A round's 5-model ensemble (4 sources and the 3-class target model)
    through the port's plain pixel-major pass and the JAX package's
    `fused_pseudo_pass`: labels equal, confidences within 1e-5."""
    rng = np.random.default_rng(7)
    names = ("camvid", "cityscapes", "forest", "camvid")
    convs = [label_conversion_matrix(n) for n in names]
    convs.append(np.concatenate([np.eye(3, dtype=np.float32),
                                 np.zeros((3, 1), np.float32)], axis=1))
    logits = [rng.normal(0, 2, (2, 9, 13, c)).astype(np.float32)
              for c in (11, 19, 5, 11, 3)]
    kc = np.asarray([0.4, 0.5, 0.6], np.float32)
    want_l, want_c = fused_pseudo_pass(
        [jnp.asarray(x) for x in logits], [jnp.asarray(c) for c in convs],
        mode=mode, kc=jnp.asarray(kc))
    got_l, got_c = pseudo.fused_pseudo_pass_plain(
        [torch.from_numpy(x) for x in logits], convs, mode=mode,
        kc=torch.from_numpy(kc))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
