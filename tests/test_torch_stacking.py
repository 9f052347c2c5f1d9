"""Ensemble weight stacking in the port (`layers/stacking.py`, `stack=` on
the model family) against the JAX package on the CPU.

The layout helpers and the tree functions are held bit for bit against
the JAX package's on the same inputs.  The port's stacked forwards (eval
on both encoder routes, train with its BatchNorm statistics) are held
against the port's per-model forwards at the reference's own tolerance
(tests/test_stacked.py: rtol 2e-3, atol 2e-4, argmax agreement above
0.999; only the order of the reductions differs), heterogeneous heads
padded to the widest must give their pad classes exactly 0 softmax mass,
and one stacked eval forward is held against the JAX package's stacked
forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mspl_tpu.layers import stacking as jst
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu_torch.layers.stacking import (block_diag_dense, flatten_tree,
                                            pad_variables_to_template,
                                            stack_variables, stacked_concat,
                                            stacked_shuffle)
from mspl_tpu_torch.models.espnetv2 import EESPNet, ESPNetv2Segmentation
from mspl_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables)
from tests.test_torch_model import flax_variables as flax_tree

HW = (32, 48)
KW = dict(s=0.5, dec_base_planes=8)
UNIFORM = 6          # classes of each of three same-width members
HETERO = (11, 19, 5)  # the main path's heads, at dec_base_planes 16
RTOL, ATOL, AGREE = 2e-3, 2e-4, 0.999


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's CPU ops on two threads for this module: the tests run in
    several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(
        0, 3, 1, 2)


def _same_trees(got, want):
    g, w = flatten_tree(got), flatten_tree(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg=str(k))


def _port(classes, variables=None, **kw):
    model = ESPNetv2Segmentation(classes, **{**KW, **kw})
    if variables is not None:
        load_flax_variables(model, variables)
    return model.eval()


def _forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()


def _check_block(block, want):
    np.testing.assert_allclose(block, want, rtol=RTOL, atol=ATOL)
    agree = (block.argmax(1) == want.argmax(1)).mean()
    assert agree > AGREE, agree


@pytest.fixture(scope="module")
def uniform():
    members = [flax_tree(FlaxESPNetv2(num_classes=UNIFORM,
                                      channel_major_logits=True, **KW),
                         HW, seed=30 + i) for i in range(3)]
    x = np.random.default_rng(3).normal(0, 1, (2, *HW, 3)).astype(
        np.float32)
    return dict(members=members, stacked=stack_variables(members), x=x)


@pytest.fixture(scope="module")
def hetero():
    kw = dict(KW, dec_base_planes=16)
    members = [flax_tree(FlaxESPNetv2(num_classes=c, **kw), HW, seed=40 + i)
               for i, c in enumerate(HETERO)]
    template = flax_tree(FlaxESPNetv2(num_classes=max(HETERO), **kw), HW,
                         seed=49)
    return dict(members=members, template=template, kw=kw)


def test_stacked_concat_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)
    b = rng.normal(size=(2, 4, 5, 9)).astype(np.float32)
    want = jst.stacked_concat([jnp.asarray(a), jnp.asarray(b)], stack=3)
    got = stacked_concat([_nchw(a), _nchw(b)], stack=3)
    np.testing.assert_array_equal(got.numpy(), _nchw(want).numpy())
    plain = stacked_concat([_nchw(a), _nchw(b)], stack=1)
    np.testing.assert_array_equal(plain.numpy(), torch.cat(
        [_nchw(a), _nchw(b)], 1).numpy())


def test_stacked_shuffle_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 3, 4, 30)).astype(
        np.float32)
    want = jst.stacked_shuffle(jnp.asarray(x), groups=5, stack=2)
    got = stacked_shuffle(_nchw(x), groups=5, stack=2)
    np.testing.assert_array_equal(got.numpy(), _nchw(want).numpy())


def test_block_diag_dense_matches_jax_and_the_grouped_conv():
    """JAX's dense HWIO kernel, in torch's OIHW layout, is the port's; a
    conv with it equals the conv grouped by the stack."""
    rng = np.random.default_rng(2)
    hwio = rng.normal(size=(3, 3, 4, 3 * 5)).astype(np.float32)
    want = np.asarray(jst.block_diag_dense(jnp.asarray(hwio), stack=3))
    oihw = torch.from_numpy(hwio).permute(3, 2, 0, 1).contiguous()
    got = block_diag_dense(oihw, stack=3)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)
    x = torch.from_numpy(rng.normal(size=(2, 12, 7, 9)).astype(np.float32))
    torch.testing.assert_close(F.conv2d(x, got, padding=1),
                               F.conv2d(x, oihw, padding=1, groups=3),
                               rtol=1e-5, atol=1e-5)


def test_stack_variables_matches_jax(uniform):
    _same_trees(uniform["stacked"],
                jst.stack_variables(uniform["members"]))


def test_stack_variables_pads_the_classifier_as_jax(uniform):
    got = stack_variables(uniform["members"], pad_classifier_to=8)
    _same_trees(got, jst.stack_variables(uniform["members"],
                                         pad_classifier_to=8))
    bias = got["params"]["bu_dec_l4"]["classify"]["Conv_0"]["bias"]
    assert bias.shape == (24,) and (bias.reshape(3, 8)[:, 6:] == -1e4).all()


def test_pad_variables_to_template_matches_jax(hetero):
    for v in hetero["members"]:
        _same_trees(pad_variables_to_template(v, hetero["template"]),
                    jst.pad_variables_to_template(v, hetero["template"]))
    with pytest.raises(ValueError, match="disagree"):
        stack_variables(hetero["members"])


def test_stacked_tree_round_trips_through_the_bridge(uniform):
    """A stacked tree loads into a `stack=3` model and comes back bit for
    bit: the bridge's walk follows the stacked modules' shapes."""
    model = _port(UNIFORM, uniform["stacked"], stack=3)
    _same_trees(flax_variables(model), uniform["stacked"])
    with pytest.raises(ValueError, match="shape"):
        _port(UNIFORM, uniform["stacked"])


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["default", "use_pallas"])
def test_stacked_eval_matches_the_members(uniform, use_pallas):
    """Each model's channel block of the stacked eval logits against that
    model's own forward; the `use_pallas` route takes the branch stack's
    plain version here and reorders its branch-major output to m-major."""
    stacked = _forward(_port(UNIFORM, uniform["stacked"], stack=3,
                             use_pallas=use_pallas), uniform["x"])
    assert stacked.shape == (2, 3 * UNIFORM, *HW)
    for i, v in enumerate(uniform["members"]):
        _check_block(stacked[:, i * UNIFORM:(i + 1) * UNIFORM],
                     _forward(_port(UNIFORM, v), uniform["x"]))


def test_stacked_train_forward_and_statistics_match_the_members(uniform):
    """Train mode: the logits blocks, then every running statistic of the
    stacked model against each member's (`merge_br`'s per scale block)."""
    x = torch.from_numpy(uniform["x"]).permute(0, 3, 1, 2)
    model = _port(UNIFORM, uniform["stacked"], stack=3).train()
    with torch.no_grad():
        stacked = model(x).numpy()
    stats = dict(model.named_buffers())
    for i, v in enumerate(uniform["members"]):
        member = _port(UNIFORM, v).train()
        with torch.no_grad():
            _check_block(stacked[:, i * UNIFORM:(i + 1) * UNIFORM],
                         member(x).numpy())
        for name, t in member.named_buffers():
            if not t.is_floating_point():
                continue
            n, stk = t.numel(), stats[name].numpy()
            got = (stk.reshape(5, 3, n // 5)[:, i].ravel()
                   if ".merge_br." in name else stk[i * n:(i + 1) * n])
            np.testing.assert_allclose(got, t.numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=name)


def test_heterogeneous_heads_give_pad_classes_no_mass(hetero):
    """11, 19 and 5 classes (proj widths 8, 9, 8) padded to the 19-class
    template and stacked: each model's true classes as its own forward,
    its pad classes exactly 0 softmax mass."""
    pad = max(HETERO)
    padded = [pad_variables_to_template(v, hetero["template"])
              for v in hetero["members"]]
    x = np.random.default_rng(9).normal(0, 1, (2, *HW, 3)).astype(np.float32)
    stacked = _forward(_port(pad, stack_variables(padded), stack=3,
                             dec_base_planes=16), x)
    for i, (c, v) in enumerate(zip(HETERO, hetero["members"])):
        block = stacked[:, i * pad:(i + 1) * pad]
        _check_block(block[:, :c], _forward(_port(c, v, dec_base_planes=16),
                                            x))
        if c < pad:
            mass = torch.softmax(torch.from_numpy(block), dim=1)[:, c:]
            assert float(mass.max()) == 0.0


def test_stacked_eval_matches_jax(uniform):
    """The port's stacked eval forward against the JAX package's
    (`stack=3`, channel-major logits) from the same stacked tree: within
    1e-4 (fp32 sums in another order; measured 6e-7), argmax equal."""
    model = FlaxESPNetv2(num_classes=UNIFORM, channel_major_logits=True,
                         stack=3, **KW)
    want = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        uniform["stacked"], jnp.asarray(uniform["x"])))
    got = _forward(_port(UNIFORM, uniform["stacked"], stack=3), uniform["x"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_stacking_refuses_fuse_stages_and_the_classifier_as_jax():
    with pytest.raises(ValueError, match="fuse_stages"):
        ESPNetv2Segmentation(UNIFORM, stack=2, fuse_stages=True, **KW)
    with pytest.raises(ValueError, match="fuse_stages"):
        jax.eval_shape(lambda: FlaxESPNetv2(
            num_classes=UNIFORM, stack=2, fuse_stages=True, **KW).init(
                jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))))
    with pytest.raises(ValueError, match="classification head"):
        EESPNet(s=0.5, num_classes=10, stack=2)
