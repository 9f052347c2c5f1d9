"""The PyTorch port's encoder kernels on CPU tensors (their plain versions)
against the JAX package's Pallas entries in interpret mode, and the port's
ESPNetv2 encoder routes against the flax model.

Kernels: eesp_branches (5, pallas_eesp.py), eesp_stage_fused_eval (6,
pallas_eesp_stage.py, with the port's own `eesp_block_params`), down_front
(7, pallas_downsampler.py).  Inputs come from numpy seeds and go to both
sides as the same arrays; the fp32 tolerances are those of the JAX
package's own kernel tests.  The model routes (`use_pallas`, `fuse_stages`)
are compared with the flax model with its flags off, which the JAX
package's own slow tests hold equal to its flag-on routes.  A CPU tensor
never reaches a CUDA launch, so every launch counter stays at 0 here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.layers.eesp import EESP as FlaxEESP
from mspl_tpu.layers.eesp import branch_dilations
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu.ops.pallas_downsampler import down_front_pallas
from mspl_tpu.ops.pallas_eesp import eesp_branches_pallas
from mspl_tpu.ops.pallas_eesp_stage import eesp_block_params as jax_params
from mspl_tpu.ops.pallas_eesp_stage import eesp_stage_fused_eval as jax_stage
from mspl_tpu_torch.layers.eesp import EESP
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.ops.eesp_branches import (down_front, eesp_branches,
                                              pack_taps)
from mspl_tpu_torch.ops.eesp_stage import (eesp_block_params,
                                           eesp_stage_fused_eval)
from mspl_tpu_torch.pseudo.generate import PseudoLabelGenerator, make_source
from mspl_tpu_torch.utils.flax_bridge import load_flax_variables

from tests.test_torch_model import _plain_dicts, flax_variables

HW = (32, 48)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _no_launches():
    return (eesp_branches.launches, down_front.launches,
            eesp_stage_fused_eval.launches) == (0, 0, 0)


@pytest.mark.parametrize("dilations", [(1, 2, 3, 4), (1, 1, 2, 3), (2, 2)])
@pytest.mark.parametrize("hw", [(11, 13), (4, 7)])
def test_eesp_branches_matches_pallas(dilations, hw):
    rng = np.random.default_rng(sum(dilations) + hw[0])
    n = 8
    x = rng.normal(size=(2, *hw, n)).astype(np.float32)
    w = rng.normal(size=(len(dilations), 3, 3, n)).astype(np.float32)
    want = eesp_branches_pallas(jnp.asarray(x), jnp.asarray(w), dilations,
                                interpret=True)
    got = eesp_branches(_nchw(x), pack_taps(_t(w)), dilations)
    assert got.shape == (2, len(dilations) * n, *hw)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert _no_launches()


@pytest.mark.parametrize("shape,dilations", [
    ((2, 24, 36, 6, 5), (1, 2, 4, 8)),
    ((1, 13, 21, 4, 4), (1, 2, 4, 8)),
    ((2, 9, 15, 3, 8), (1, 2, 3, 4)),
])
def test_down_front_matches_pallas(shape, dilations):
    b, h, w, nin, n = shape
    rng = np.random.default_rng(h * w)
    x = rng.normal(size=(b, h, w, nin)).astype(np.float32)
    proj = rng.normal(size=(b, h, w, n)).astype(np.float32)
    wts = (rng.normal(size=(len(dilations), 3, 3, n)) * 0.3).astype(np.float32)
    want_pool, want_br = down_front_pallas(
        jnp.asarray(x), jnp.asarray(proj), jnp.asarray(wts), dilations,
        interpret=True)
    pool, br = down_front(_nchw(x), _nchw(proj), pack_taps(_t(wts)),
                          dilations)
    h2, w2 = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    assert pool.shape == (b, nin, h2, w2)
    assert br.shape == (b, len(dilations) * n, h2, w2)
    np.testing.assert_allclose(_nhwc(pool), np.asarray(want_pool), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_nhwc(br), np.asarray(want_br), rtol=1e-5,
                               atol=1e-5)
    assert _no_launches()


def _randomize_stats(v, rng):
    """Perturbed BN statistics (means ~N(0, 0.3), variances in [0.5, 1.5])
    and PReLU alphas, as nested dicts of numpy arrays."""
    def walk(tree):
        out = {}
        for k, sub in tree.items():
            if hasattr(sub, "items"):
                out[k] = walk(sub)
            elif k == "mean":
                out[k] = (rng.normal(size=sub.shape) * 0.3).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, sub.shape).astype(np.float32)
            elif k == "alpha":
                out[k] = rng.uniform(0.0, 0.5, sub.shape).astype(np.float32)
            else:
                out[k] = np.array(sub)
        return out
    return walk(v)


def _chain(c, k, r_lim, hw, seed):
    """A 2-unit flax EESP chain with perturbed statistics, the same
    variables loaded into two port units, and the flax chain's output."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *hw, c)).astype(np.float32)
    y, units, flax_vars = jnp.asarray(x), [], []
    for i in range(2):
        blk = FlaxEESP(c, stride=1, k=k, r_lim=r_lim)
        v = _randomize_stats(_plain_dicts(blk.init(jax.random.PRNGKey(i), y,
                                                   train=False)), rng)
        y = blk.apply(v, y, train=False)
        unit = EESP(c, c, k=k, r_lim=r_lim).eval()
        load_flax_variables(unit, v)
        units.append(unit)
        flax_vars.append(v)
    return x, units, flax_vars, np.asarray(y)


# grouped expand (n % k == 0), dense expand (n = 6), and a 3x5 plane that
# the dilations 3 and 4 reach past
@pytest.mark.parametrize("c,hw", [(16, (8, 12)), (24, (8, 12)), (16, (3, 5))])
def test_eesp_stage_matches_pallas(c, hw):
    k, r_lim = 4, 9
    x, units, flax_vars, _ = _chain(c, k, r_lim, hw, seed=c + hw[0])
    dil = branch_dilations(k, r_lim)
    want_params = [jax_params(v["params"], v["batch_stats"], k)
                   for v in flax_vars]
    want = jax_stage(jnp.asarray(x), want_params, dil, interpret=True,
                     max_blocks=1)
    params = [eesp_block_params(u) for u in units]
    assert params[0]["ew"].dim() == (3 if c == 16 else 2)
    for got_p, want_p in zip(params, want_params):
        for name, arr in want_p.items():
            np.testing.assert_allclose(got_p[name].numpy(), np.asarray(arr),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    got = eesp_stage_fused_eval(_nchw(x), params, dil)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=5e-4,
                               atol=5e-4)
    # the same chain unit by unit through the port's modules
    with torch.no_grad():
        ref = _nchw(x)
        for u in units:
            ref = u(ref)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=5e-4,
                               atol=5e-4)
    assert _no_launches()


def test_eesp_block_params_follow_weight_swaps():
    """The folded arrays are cached on the unit; an in-place load of new
    variables (as set_variables does) must refold them."""
    k, r_lim, c = 4, 9, 16
    _, units, flax_vars, _ = _chain(c, k, r_lim, (8, 12), seed=5)
    first = eesp_block_params(units[0])
    assert eesp_block_params(units[0]) is first
    v = flax_vars[1]
    load_flax_variables(units[0], v)
    swapped = eesp_block_params(units[0])
    assert swapped is not first
    want = jax_params(v["params"], v["batch_stats"], k)
    for name, arr in want.items():
        np.testing.assert_allclose(swapped[name].numpy(), np.asarray(arr),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def model_case():
    model = FlaxESPNetv2(num_classes=11, s=0.5, dec_base_planes=8,
                         channel_major_logits=True)
    variables = flax_variables(model, HW, seed=2)
    x = np.random.default_rng(9).normal(0, 1, (2, *HW, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    return variables, x, want


@pytest.mark.parametrize("flags", [dict(use_pallas=True),
                                   dict(fuse_stages=True),
                                   dict(use_pallas=True, fuse_stages=True)],
                         ids=["use_pallas", "fuse_stages", "both"])
def test_encoder_routes_match_flax(model_case, flags):
    variables, x, want = model_case
    port = ESPNetv2Segmentation(11, s=0.5, dec_base_planes=8, **flags)
    load_flax_variables(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 11, *HW)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(1) == want.argmax(1)).all()
    assert _no_launches()


def test_fuse_stages_generator_follows_set_variables(model_case):
    """set_variables loads new weights in place; the fused stages' folded
    arrays, cached on each unit, must follow them."""
    variables, _, _ = model_case
    other = flax_variables(FlaxESPNetv2(num_classes=11, s=0.5,
                                        dec_base_planes=8), HW, seed=5)

    def generator(v):
        model = ESPNetv2Segmentation(11, s=0.5, dec_base_planes=8,
                                     fuse_stages=True)
        return PseudoLabelGenerator(
            [make_source("camvid", model, v, "camvid", channel_major=True,
                         device="cpu")], device="cpu")

    imgs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, *HW, 3), dtype=np.uint8))
    gen = generator(variables)
    before = gen.batch_pass(imgs)
    gen.set_variables(0, other)
    after, fresh = gen.batch_pass(imgs), generator(other).batch_pass(imgs)
    assert torch.equal(after[0], fresh[0]) and torch.equal(after[1], fresh[1])
    assert not torch.equal(before[1], after[1])
    assert _no_launches()


@pytest.mark.parametrize("flags", [dict(use_pallas=True),
                                   dict(fuse_stages=True)],
                         ids=["use_pallas", "fuse_stages"])
def test_encoder_routes_keep_the_parameter_tree(flags):
    """Same tree for every flag.  In train the `use_pallas` route raises
    (its branch kernel is eval only) and `fuse_stages` runs unit by unit,
    as the reference does: the plain model's train forward, bit for bit."""
    plain = ESPNetv2Segmentation(5, s=0.5, dec_base_planes=8)
    routed = ESPNetv2Segmentation(5, s=0.5, dec_base_planes=8, **flags)
    shapes = lambda m: {k: tuple(v.shape)  # noqa: E731
                        for k, v in m.state_dict().items()}
    assert shapes(routed) == shapes(plain)
    routed.load_state_dict(plain.state_dict())
    plain.train()
    routed.train()
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (2, 3, 32, 48)).astype(np.float32))
    if flags.get("use_pallas"):
        with pytest.raises(NotImplementedError, match="eval-only"):
            routed(x)
        return
    torch.testing.assert_close(routed(x), plain(x), rtol=0, atol=0)
