"""The launch plan of the fused pseudo-label kernel (kernel 1 of the port,
`csrc/pseudo_cm.cuh`) on the CPU.

The kernel reads 4 pixels of a plane a thread, each model's channels in a
register width rounded up to 4 (loads past C_m repeat the last plane and
stay out of the sums), with the tables padded to 4 or 8 columns.  These
tests hold the wrapper's plan (`launch_plan`), and a plain model of that
layout, to the JAX package's fused pass at a pixel count that is not a
multiple of 4 (its reference pass on NHWC logits: the Pallas kernel takes
only heights in multiples of 8).  Inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data.label_space import label_conversion_matrix
from mspl_tpu.ops.pallas_pseudo_cm import fused_pseudo_cm
from mspl_tpu.pseudo.generate import fused_pseudo_pass
from mspl_tpu_torch.ops.pseudo_cm import (MAX_C, MAX_MODELS,
                                          PIXELS_PER_THREAD,
                                          fused_pseudo_cm_plain, launch_plan)

SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))


@pytest.mark.parametrize("hw,aligned,vec", [(256 * 480, True, True),
                                            (17 * 29, True, False),
                                            (16 * 24, False, False)])
def test_plan_at_the_main_path_and_odd_planes(hw, aligned, vec):
    """The main path's sources take widths 12, 20 and 8 (Cityscapes' 19
    channels issue 20 loads, not 32) and the 4-column table instance for
    T + 1 = 4; a vector load a channel only where every plane starts on
    its word."""
    widths, t1, got_vec = launch_plan([c for _, c in SOURCES], 3, hw,
                                      aligned)
    assert widths == (12, 20, 8) and t1 == 4 and got_vec == vec


@pytest.mark.parametrize("c", range(1, MAX_C + 1))
def test_plan_widths(c):
    """Every channel count up to the kernel's limit takes the least
    multiple of 4 that holds it, at most 3 loads more than its planes."""
    (width,), t1, _ = launch_plan([c], 7, 64, True)
    assert width % 4 == 0 and c <= width <= min(c + 3, MAX_C) and t1 == 8


def _plan_model(logits, convs, kc):
    """Soft fusion with prob confidence as the kernel forms it from the
    plan: each plane cut into chunks of PIXELS_PER_THREAD pixels (zero past
    the plane's end, those pixels dropped), each model's loads at its
    register width (the last plane repeated), only its C_m planes in the
    max and the sums, tables padded with zero columns to the instance's
    width."""
    n_t = convs[0].shape[1] - 1
    b, _, h, w = logits[0].shape
    hw = h * w
    widths, t1, _ = launch_plan([x.shape[1] for x in logits], n_t, hw, False)
    chunks = -(-hw // PIXELS_PER_THREAD)
    acc = torch.zeros((b, t1, chunks * PIXELS_PER_THREAD))
    for x, conv, width in zip(logits, convs, widths):
        c = x.shape[1]
        flat = torch.zeros((b, c, chunks * PIXELS_PER_THREAD))
        flat[:, :, :hw] = x.reshape(b, c, hw)
        loaded = flat[:, [min(i, c - 1) for i in range(width)]]
        real = loaded[:, :c]
        e = torch.exp(real - real.amax(dim=1, keepdim=True))
        tab = torch.zeros((c, t1))
        tab[:, :n_t + 1] = torch.from_numpy(conv)
        q = torch.einsum("bcp,ct->btp", e, tab) * (1.0 / e.sum(dim=1))[:, None]
        acc[:, :n_t] += q[:, :n_t]
    fused = (acc[:, :n_t, :hw] / len(logits)).reshape(b, n_t, h, w)
    conf, lbl = fused.max(dim=1)
    lbl = torch.where(conf >= kc[lbl], lbl, torch.full_like(lbl, 255))
    return lbl.to(torch.int32), conf


def test_plan_model_matches_jax_at_an_odd_pixel_count():
    """At batch 3 and 17 x 29 pixels (not a multiple of 4) the plan's
    layout gives the JAX package's fused pass and the port's plain
    version: labels equal, confidences within 1e-5."""
    rng = np.random.default_rng(29)
    logits = [rng.normal(0, 2, (3, c, 17, 29)).astype(np.float32)
              for _, c in SOURCES]
    convs = [label_conversion_matrix(n) for n, _ in SOURCES]
    kc = np.asarray([0.4, 0.5, 0.6], np.float32)
    want_l, want_c = fused_pseudo_pass(
        [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in logits],
        [jnp.asarray(c) for c in convs], kc=jnp.asarray(kc))
    got_l, got_c = _plan_model([torch.from_numpy(x) for x in logits], convs,
                               torch.from_numpy(kc))
    plain_l, plain_c = fused_pseudo_cm_plain(
        [torch.from_numpy(x) for x in logits], convs, torch.from_numpy(kc))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got_l.numpy(), plain_l.numpy())
    np.testing.assert_allclose(got_c.numpy(), plain_c.numpy(), rtol=0,
                               atol=1e-5)


# ensembles past the main path's 3 models: a self-training round with 4
# sources (its target model the fifth, 3 classes) and the kernel's limit of
# 8 models, at the registry's widest source (19 classes) and at MAX_C
MANY = [(11, 19, 5, 11, 3), (11, 19, 5, 11, 19, 5, 11, 19), (32,) * 8]


@pytest.mark.parametrize("channels", MANY, ids=["5", "8", "8x32"])
def test_plan_at_5_and_8_models(channels):
    """Each model keeps its own register width up to the kernel's 8
    models; the tables (8 models of MAX_C rows, 4 or 8 columns) stay 8 KB
    of static shared memory at most."""
    widths, t1, vec = launch_plan(list(channels), 3, 16 * 24, True)
    assert len(widths) == len(channels) <= MAX_MODELS == 8
    assert widths == tuple(-(-c // 4) * 4 for c in channels)
    assert t1 == 4 and vec
    assert 4 * MAX_MODELS * MAX_C * 8 <= 8 * 1024


@pytest.mark.parametrize("mode,conf_mode", [("soft", "prob"),
                                            ("hard", "entropy")])
def test_plain_matches_jax_at_5_models(mode, conf_mode):
    """A round's 5-model ensemble (4 sources and the 3-class target model)
    through the port's plain channel-major pass and the JAX package's
    `fused_pseudo_cm` in interpret mode: labels equal, confidences within
    1e-5."""
    rng = np.random.default_rng(5)
    chans = MANY[0]
    names = ("camvid", "cityscapes", "forest", "camvid")
    convs = [label_conversion_matrix(n) for n in names]
    convs.append(np.concatenate([np.eye(3, dtype=np.float32),
                                 np.zeros((3, 1), np.float32)], axis=1))
    logits = [rng.normal(0, 2, (2, c, 16, 24)).astype(np.float32)
              for c in chans]
    kc = np.asarray([0.4, 0.5, 0.6], np.float32)
    want_l, want_c = fused_pseudo_cm(
        [jnp.asarray(x) for x in logits], convs, jnp.asarray(kc), mode=mode,
        conf_mode=conf_mode, interpret=True)
    got_l, got_c = fused_pseudo_cm_plain(
        [torch.from_numpy(x) for x in logits], convs, torch.from_numpy(kc),
        mode=mode, conf_mode=conf_mode)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
