"""The port's pixel-major fused pseudo-label pass (8, ops/pseudo.py) against
the JAX package's `fused_pseudo_pass_pallas` in interpret mode, and the
generator's `use_pallas` route against the JAX generator, on the CPU.

NHWC sources with `use_pallas=True` take the pixel-major pass in both
packages; channel-major sources take the channel-major pass whatever the
flag says.  Inputs come from numpy seeds; a CPU tensor never reaches a CUDA
launch, so the launch counters stay at 0 here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data.label_space import label_conversion_matrix
from mspl_tpu.data.loader import DataLoader as JaxDataLoader
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu.ops.pallas_pseudo import fused_pseudo_pass_pallas
from mspl_tpu.pseudo import generate as jax_gen
from mspl_tpu_torch.data.loader import DataLoader
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.ops import pseudo_cm
from mspl_tpu_torch.ops.pseudo import fused_pseudo_pass_pm
from mspl_tpu_torch.pseudo import generate
from mspl_tpu_torch.pseudo.generate import PseudoLabelGenerator, make_source

from tests.test_torch_generate import _Images, _variables

SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))
KC = np.asarray([0.45, 0.5, 0.55], np.float32)
HW = (32, 48)
N_IMAGES, BATCH = 6, 4


def _logits(seed, b=2, h=7, w=13):
    """N NHWC logit stacks; 2*7*13 = 182 pixels, not a multiple of the TPU
    kernel's 1024-pixel tile."""
    rng = np.random.default_rng(seed)
    return ([(rng.normal(0, 3, (b, h, w, c))).astype(np.float32)
             for _, c in SOURCES],
            [label_conversion_matrix(n) for n, _ in SOURCES])


@pytest.mark.parametrize("with_kc", [False, True])
@pytest.mark.parametrize("conf_mode", ["prob", "entropy"])
@pytest.mark.parametrize("mode,min_agree",
                         [("soft", None), ("hard", None), ("hard", 1),
                          ("hard", 3)])
def test_fused_pseudo_pass_pm_matches_pallas(mode, min_agree, conf_mode,
                                             with_kc):
    logits, convs = _logits(seed=31)
    kc = KC if with_kc else None
    want_l, want_c = fused_pseudo_pass_pallas(
        [jnp.asarray(x) for x in logits], convs, mode=mode,
        kc=None if kc is None else jnp.asarray(kc), min_agree=min_agree,
        conf_mode=conf_mode, interpret=True)
    got_l, got_c = fused_pseudo_pass_pm(
        [torch.from_numpy(x) for x in logits], convs, mode=mode,
        kc=None if kc is None else torch.from_numpy(kc), min_agree=min_agree,
        conf_mode=conf_mode)
    assert got_l.dtype == torch.int32 and got_c.dtype == torch.float32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
    assert fused_pseudo_pass_pm.launches == 0


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_fused_pseudo_pass_pm_kc_none_thresholds_nothing(mode):
    """Uniform logits give an entropy confidence at 0 that may round below
    it: without kc the pixel-major pass keeps its label (the channel-major
    pass would set it to ignore)."""
    logits = [np.zeros((1, 3, 5, c), np.float32) for _, c in SOURCES]
    convs = [label_conversion_matrix(n) for n, _ in SOURCES]
    want_l, want_c = fused_pseudo_pass_pallas(
        [jnp.asarray(x) for x in logits], convs, mode=mode,
        conf_mode="entropy", min_agree=1, interpret=True)
    got_l, got_c = fused_pseudo_pass_pm(
        [torch.from_numpy(x) for x in logits], convs, mode=mode,
        conf_mode="entropy", min_agree=1)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def nhwc_sweep():
    models = [FlaxESPNetv2(num_classes=c, s=0.5, dec_base_planes=8)
              for _, c in SOURCES]
    variables = [_variables(m, seed=40 + i) for i, m in enumerate(models)]
    data = _Images(seed=7)
    jsrcs = [jax_gen.make_source(name, m, v, name, channel_major=False)
             for (name, _), m, v in zip(SOURCES, models, variables)]
    want = jax_gen.PseudoLabelGenerator(jsrcs, mode="soft", kc=KC,
                                        use_pallas=True)(
        JaxDataLoader(data, batch_size=BATCH, num_workers=1))
    return variables, data, want


def _port_sources(variables, channel_major):
    return [make_source(name, ESPNetv2Segmentation(c, s=0.5,
                                                   dec_base_planes=8),
                        v, name, channel_major=channel_major, device="cpu")
            for (name, c), v in zip(SOURCES, variables)]


def test_generator_use_pallas_matches_jax(nhwc_sweep):
    variables, data, (wl, wc, wi) = nhwc_sweep
    gen = PseudoLabelGenerator(_port_sources(variables, False), mode="soft",
                               kc=KC, use_pallas=True, device="cpu")
    assert gen.use_pallas
    gl, gc, gi = gen(DataLoader(data, batch_size=BATCH, num_workers=1))
    np.testing.assert_array_equal(gi, wi)
    assert np.unique(np.round(wc, 3)).size > 50
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-5)
    assert fused_pseudo_pass_pm.launches == 0


def test_channel_major_sources_ignore_use_pallas(nhwc_sweep, monkeypatch):
    """Channel-major sources keep the channel-major pass (1) with
    use_pallas=True, as the JAX package's generator does."""
    variables, data, _ = nhwc_sweep
    calls = []

    def spy(*args, **kwargs):
        calls.append(1)
        return pseudo_cm.fused_pseudo_cm(*args, **kwargs)

    monkeypatch.setattr(generate, "fused_pseudo_cm", spy)
    loader = lambda: DataLoader(data, batch_size=BATCH,  # noqa: E731
                                num_workers=1)
    on = PseudoLabelGenerator(_port_sources(variables, True), kc=KC,
                              use_pallas=True, device="cpu")
    assert not on.use_pallas
    got = on(loader())
    assert len(calls) == 2  # one per batch
    off = PseudoLabelGenerator(_port_sources(variables, True), kc=KC,
                               device="cpu")(loader())
    for a, b in zip(got, off):
        np.testing.assert_array_equal(a, b)
