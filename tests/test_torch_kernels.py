"""The PyTorch port's kernel wrappers on CPU tensors (their plain versions)
against the JAX package's Pallas entries in interpret mode, at a tiny shape.

Each Pallas contract of the pseudo-label main path has one counterpart in
`mspl_tpu_torch.ops`: fused_pseudo_cm (1), pyr_pool_fused_eval_v3 (2),
pyr_branches_pallas (3), resize_x2_cm_pallas (4).  Inputs come from numpy
seeds and go to both sides as the same arrays; the fp32 tolerances are those
of the JAX package's own kernel tests.  A CPU tensor must never reach a CUDA
launch, so every launch counter stays at 0 here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data.label_space import label_conversion_matrix
from mspl_tpu.ops.pallas_pseudo_cm import fused_pseudo_cm as jax_fused_cm
from mspl_tpu.ops.pallas_pyrpool import (pyr_branches_pallas,
                                         pyr_pool_fused_eval_v3)
from mspl_tpu.ops.pallas_resize import resize_x2_cm_pallas
from mspl_tpu_torch.ops.pseudo_cm import fused_pseudo_cm
from mspl_tpu_torch.ops.pyrpool import pyr_branches, pyr_pool_fused_eval
from mspl_tpu_torch.ops.resize_x2 import resize_x2_cm

B, H, W, P = 1, 16, 24, 8
SCALES = (2.0, 1.5, 1.0, 0.5, 0.1)
SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _logits(seed, uniform=False):
    rng = np.random.default_rng(seed)
    out = []
    for _, c in SOURCES:
        x = (np.zeros((B, c, H, W), np.float32) if uniform
             else (rng.normal(0, 2, (B, c, H, W))).astype(np.float32))
        out.append(x)
    return out, [label_conversion_matrix(n) for n, _ in SOURCES]


def _no_launches():
    return (fused_pseudo_cm.launches, pyr_branches.launches,
            pyr_pool_fused_eval.launches, resize_x2_cm.launches) == (0,) * 4


@pytest.mark.parametrize("with_kc", [False, True])
@pytest.mark.parametrize("conf_mode", ["prob", "entropy"])
@pytest.mark.parametrize("mode,min_agree",
                         [("soft", None), ("hard", None), ("hard", 1)])
def test_fused_pseudo_cm_matches_pallas(mode, min_agree, conf_mode, with_kc):
    logits, convs = _logits(seed=11)
    kc = np.asarray([0.4, 0.5, 0.6], np.float32) if with_kc else None
    want_l, want_c = jax_fused_cm(
        [jnp.asarray(x) for x in logits], convs,
        None if kc is None else jnp.asarray(kc), mode=mode,
        min_agree=min_agree, conf_mode=conf_mode, interpret=True)
    got_l, got_c = fused_pseudo_cm(
        [_t(x) for x in logits], convs, None if kc is None else _t(kc),
        mode=mode, min_agree=min_agree, conf_mode=conf_mode)
    assert got_l.dtype == torch.int32 and got_c.dtype == torch.float32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
    assert _no_launches()


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_fused_pseudo_cm_uniform_logits_keep_kernel_threshold(mode):
    """kc=None thresholds against 0 in the kernel (the plain NHWC pass does
    not threshold at all): an entropy confidence of uniform logits that
    rounds below 0 must be set to ignore exactly as the kernel does."""
    logits, convs = _logits(seed=0, uniform=True)
    want_l, want_c = jax_fused_cm([jnp.asarray(x) for x in logits], convs,
                                  None, mode=mode, conf_mode="entropy",
                                  interpret=True)
    got_l, got_c = fused_pseudo_cm([_t(x) for x in logits], convs, None,
                                   mode=mode, conf_mode="entropy")
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)


def _pyr_inputs(seed, p=P, o=11, last_br=True):
    rng = np.random.default_rng(seed)
    s_n = len(SCALES)
    f = lambda *shape, sd=1.0: rng.normal(0, sd, shape).astype(np.float32)

    def affine(n):  # perturbed BN scale/shift and PReLU alpha
        return np.stack([rng.uniform(0.5, 1.5, n), rng.normal(0, 0.1, n),
                         rng.uniform(0.0, 0.5, n)]).astype(np.float32)

    aff3 = (affine(o) if last_br else
            np.stack([np.ones(o), np.zeros(o), np.ones(o)]).astype(np.float32))
    return dict(x=f(B, H, W, p), dw=f(s_n, 3, 3, p, sd=0.5),
                aff1=affine(s_n * p), mw=f(3, 3, s_n, p, sd=0.3),
                aff2=affine(p), cls_w=f(p, o, sd=0.5),
                cls_b=f(o, sd=0.1) if not last_br else np.zeros(o, np.float32),
                aff3=aff3)


@pytest.mark.parametrize("p", [8, 9])
def test_pyr_branches_matches_pallas(p):
    a = _pyr_inputs(seed=p, p=p)
    want = pyr_branches_pallas(jnp.asarray(a["x"]), jnp.asarray(a["dw"]),
                               SCALES, interpret=True)  # [B, H, W, S*P]
    got = pyr_branches(_t(a["x"]).permute(0, 3, 1, 2).contiguous(),
                       _t(a["dw"]), SCALES)
    assert got.shape == (B, len(SCALES) * p, H, W)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-4)
    assert _no_launches()


@pytest.mark.parametrize("o,last_br", [(11, False), (19, True), (5, False)])
def test_pyr_pool_fused_eval_matches_pallas(o, last_br):
    a = _pyr_inputs(seed=o, o=o, last_br=last_br)
    names = ("dw", "aff1", "mw", "aff2", "cls_w", "cls_b", "aff3")
    want = pyr_pool_fused_eval_v3(
        jnp.asarray(a["x"]), *[jnp.asarray(a[k]) for k in names], SCALES,
        interpret=True, channel_major_out=True)  # [B, O, H, W]
    got = pyr_pool_fused_eval(_t(a["x"]).permute(0, 3, 1, 2).contiguous(),
                              *[_t(a[k]) for k in names], SCALES)
    assert got.shape == (B, o, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert _no_launches()


@pytest.mark.parametrize("c", [11, 19, 5])
def test_resize_x2_cm_matches_pallas(c):
    x = np.random.default_rng(c).normal(0, 3, (B, c, H, W)).astype(np.float32)
    want = resize_x2_cm_pallas(jnp.asarray(x), (2 * H, 2 * W),
                               align_corners=True, interpret=True)
    got = resize_x2_cm(_t(x), (2 * H, 2 * W), align_corners=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert _no_launches()
