"""Decoder-resolution fusion in the port against the JAX package on the CPU:
`ESPNetv2Segmentation(final_resize=False)`'s logits (eval and train) against
the JAX model's with `channel_major_logits=True, final_resize=False`, and
`fused_pseudo_soft_decoder_res` against the JAX function on the same
logits, both confidences, with and without kc: labels equal, confidences
within 1e-6 (f32 sums in another order; measured 8.9e-8 for prob,
1.8e-7 for entropy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data.label_space import label_conversion_matrix as jax_table
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu.pseudo.generate import \
    fused_pseudo_soft_decoder_res as jax_fuse
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.ops.resize_x2 import resize_x2_cm_plain
from mspl_tpu_torch.pseudo.generate import fused_pseudo_soft_decoder_res
from mspl_tpu_torch.utils.flax_bridge import load_flax_variables
from tests.test_torch_model import flax_variables

HW = (32, 48)
KW = dict(s=0.5, dec_base_planes=8)
SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))
KC = np.asarray([0.4, 0.5, 0.6], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flax(c):
    return FlaxESPNetv2(num_classes=c, channel_major_logits=True,
                        final_resize=False, **KW)


def _port(c, variables, **kw):
    model = ESPNetv2Segmentation(c, **KW, **kw)
    load_flax_variables(model, variables)
    return model


@pytest.fixture(scope="module")
def case():
    x = np.random.default_rng(5).normal(0, 1, (2, *HW, 3)).astype(
        np.float32)
    trees, logits = [], []
    for i, (_, c) in enumerate(SOURCES):
        model = _flax(c)
        v = flax_variables(model, HW, seed=60 + i)
        trees.append(v)
        logits.append(np.array(jax.jit(
            lambda v, a, m=model: m.apply(v, a, train=False))(
                v, jnp.asarray(x))))
    return dict(x=x, trees=trees, logits=logits,
                tables=[jax_table(name) for name, _ in SOURCES])


def test_decoder_res_logits_match_jax(case):
    """Each source's eval logits at H/2 x W/2 within 1e-4, argmax equal;
    the full model's logits are the x2 resize of these."""
    x = torch.from_numpy(case["x"]).permute(0, 3, 1, 2)
    for (_, c), v, want in zip(SOURCES, case["trees"], case["logits"]):
        model = _port(c, v, final_resize=False).eval()
        with torch.no_grad():
            got = model(x)
            full = _port(c, v).eval()(x)
        assert got.shape == want.shape == (2, c, HW[0] // 2, HW[1] // 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
        assert (got.numpy().argmax(1) == want.argmax(1)).all()
        torch.testing.assert_close(resize_x2_cm_plain(got, HW), full,
                                   rtol=0, atol=0)


def test_decoder_res_train_logits_match_jax(case):
    """Train mode (batch statistics): the decoder-resolution logits, as the
    reference's NHWC train decoder returns them with final_resize=False,
    within 1e-4."""
    c, v = SOURCES[2][1], case["trees"][2]
    model = _flax(c)
    want, _ = jax.jit(lambda v, a: model.apply(
        v, a, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(case["x"]))
    port = _port(c, v, final_resize=False).train()
    with torch.no_grad():
        got = port(torch.from_numpy(case["x"]).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, c, HW[0] // 2, HW[1] // 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("conf_mode", ["prob", "entropy"])
@pytest.mark.parametrize("with_kc", [False, True], ids=["no_kc", "kc"])
def test_decoder_res_fusion_matches_jax(case, conf_mode, with_kc):
    kc = KC if with_kc else None
    want_lab, want_conf = jax_fuse(
        [jnp.asarray(lg) for lg in case["logits"]], case["tables"], HW,
        kc=None if kc is None else jnp.asarray(kc), conf_mode=conf_mode)
    got_lab, got_conf = fused_pseudo_soft_decoder_res(
        [torch.from_numpy(lg) for lg in case["logits"]], case["tables"], HW,
        kc=kc, conf_mode=conf_mode)
    assert got_lab.shape == (2, *HW) and got_lab.dtype == torch.int32
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    np.testing.assert_allclose(got_conf.numpy(), np.asarray(want_conf),
                               rtol=0, atol=1e-6)
    if with_kc:
        assert (got_lab.numpy() == 255).any()


def test_decoder_res_fusion_checks_its_arguments(case):
    lg = [torch.from_numpy(a) for a in case["logits"]]
    with pytest.raises(ValueError, match="matching"):
        fused_pseudo_soft_decoder_res(lg, case["tables"][:2], HW)
    with pytest.raises(ValueError, match="conf_mode"):
        fused_pseudo_soft_decoder_res(lg, case["tables"], HW,
                                      conf_mode="margin")

