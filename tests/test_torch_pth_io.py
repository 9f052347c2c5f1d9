"""The port's torch .pth import and export against the JAX package's, on
the CPU: `torch_leaf_map` (written down from the twins' naming rules in
the port, probed from the twins' transplant in the JAX package), the
import of a random state dict of the torch twin, the export of a variable
tree, and the refusals (a nonzero tensor flax has no place for, a state
dict of another architecture)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.models import build_segmentation_model as jax_build
from mspl_tpu.utils import torch_import as jax_ti
from mspl_tpu_torch.utils import torch_import as port_ti

HW = (32, 48)
# (model, classes, s, architecture kwargs)
CASES = {
    "espnetv2-s0.5": ("espnetv2", 11, 0.5, {}),
    "espnetv2-s1.0": ("espnetv2", 5, 1.0, {"dec_base_planes": 8}),
    "deeplabv3": ("deeplabv3", 4, 2.0,
                  {"stage_blocks": (1, 2, 1, 1), "aspp_features": 32}),
}


def _target(model, nc, s, kw):
    """The JAX model's variable structure (shapes only, no compile)."""
    m = jax_build(model, nc, s=s, **kw)
    return jax.eval_shape(lambda: m.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, *HW, 3), jnp.float32), train=False))


def _paths(tree):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _twin_state_dict(model, nc, s, kw, seed=0):
    twin, _ = jax_ti._build_twin(model, nc, s, **kw)
    rng = np.random.default_rng(seed)
    return {k: (torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) if v.is_floating_point() else v)
        for k, v in twin.state_dict().items()}


@pytest.mark.parametrize("case", list(CASES))
def test_leaf_map_matches_jax(case):
    model, nc, s, kw = CASES[case]
    want = jax_ti.torch_leaf_map(model, _target(model, nc, s, kw), nc, s,
                                 **kw)
    want = {k: (tuple(p.key for p in v) if isinstance(v, tuple) else v)
            for k, v in want.items()}
    assert port_ti.torch_leaf_map(model, nc, s, **kw) == want


@pytest.mark.parametrize("case", list(CASES))
def test_import_gives_the_jax_variables(case):
    """A twin state dict of random values (in a checkpoint envelope, with
    DataParallel prefixes) imports to the JAX package's variables, leaf
    for leaf and bit for bit."""
    model, nc, s, kw = CASES[case]
    sd = _twin_state_dict(model, nc, s, kw)
    want = jax_ti.variables_from_state_dict(
        model, sd, _target(model, nc, s, kw), nc, s, **kw)
    envelope = {"state_dict": {"module." + k: v for k, v in sd.items()},
                "epoch": 3}
    got = port_ti.variables_from_state_dict(model, envelope, nc, s, **kw)
    a, b = _paths(got), _paths(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
            b[k].tobytes(), k


@pytest.mark.parametrize("case", list(CASES))
def test_export_gives_the_jax_state_dict(case):
    """The export of a variable tree is the JAX package's state dict:
    every key, dtype and value, the dead tensors and BatchNorm counters
    included; and it imports back to the same tree."""
    model, nc, s, kw = CASES[case]
    variables = port_ti.variables_from_state_dict(
        model, _twin_state_dict(model, nc, s, kw, seed=1), nc, s, **kw)
    want = jax_ti.export_torch_state_dict(model, variables, nc, s, **kw)
    got = port_ti.export_torch_state_dict(model, variables, nc, s, **kw)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    back = port_ti.variables_from_state_dict(model, got, nc, s, **kw)
    a, b = _paths(back), _paths(variables)
    assert all(a[k].tobytes() == b[k].tobytes() for k in b)


def test_nonzero_tensor_without_a_flax_leaf_raises(monkeypatch):
    """A twin tensor that flax has no place for (a map entry of None, the
    reference's zero-bias rule) imports when zero and raises when not, in
    both packages."""
    model, nc, s, kw = CASES["espnetv2-s0.5"]
    sd = _twin_state_dict(model, nc, s, kw)
    name = "bu_dec_l4.classify.conv.bias"
    target = _target(model, nc, s, kw)
    port_table, jax_map = port_ti._twin_table, jax_ti.torch_leaf_map
    monkeypatch.setattr(port_ti, "_twin_table", lambda *a, **k: {
        **port_table(*a, **k), name: (None, (nc,))})
    monkeypatch.setattr(jax_ti, "torch_leaf_map", lambda *a, **k: {
        **jax_map(*a, **k), name: None})
    with pytest.raises(ValueError, match="no flax equivalent"):
        port_ti.variables_from_state_dict(model, sd, nc, s)
    with pytest.raises(ValueError, match="no flax equivalent"):
        jax_ti.variables_from_state_dict(model, sd, target, nc, s)
    zero = {**sd, name: torch.zeros_like(sd[name])}
    got = port_ti.variables_from_state_dict(model, zero, nc, s)
    assert "bias" not in got["params"]["bu_dec_l4"]["classify"]["Conv_0"]


def test_other_architecture_raises():
    model, nc, s, kw = CASES["espnetv2-s0.5"]
    sd = _twin_state_dict(model, nc, s, kw)
    with pytest.raises(ValueError, match="does not match"):
        port_ti.variables_from_state_dict("deeplabv3", sd, nc)
    with pytest.raises(ValueError, match="shape"):
        port_ti.variables_from_state_dict(model, sd, nc, 1.0)
    with pytest.raises(ValueError, match="does not match"):
        port_ti.variables_from_state_dict(
            model, {k: v for k, v in sd.items() if "level1" not in k}, nc, s)
    bad = {**sd, "base_net.level1.cb.bn.bias": torch.zeros(3)}
    with pytest.raises(ValueError, match="shape"):
        port_ti.variables_from_state_dict(model, bad, nc, s)
