"""Ghost-batch BatchNorm (`bn_stat_groups`) in the port against the JAX
package's (mspl_tpu/layers/bn.py) on the CPU: one group is today's
BatchNorm bit for bit; 2 and 4 groups give the JAX package's output and
running statistics; a batch the group count does not divide raises; and
`make_train_step(bn_groups=2)` takes the JAX package's step for ESPNetv2
and the small DeepLab of tests/test_torch_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mspl_tpu.engine.schedules import build_schedule as jax_schedule
from mspl_tpu.engine.train import build_optimizer as jax_optimizer
from mspl_tpu.engine.train import create_train_state as jax_state
from mspl_tpu.engine.train import make_train_step as jax_train_step
from mspl_tpu.layers.bn import BatchNorm as FlaxGhostBN
from mspl_tpu.layers.bn import bn_stat_groups as jax_groups
from mspl_tpu.models import DeepLabV3 as FlaxDeepLab
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu_torch.engine.losses import compute_class_weights
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import create_train_state, make_train_step
from mspl_tpu_torch.layers.conv_blocks import BatchNorm, bn_stat_groups
from mspl_tpu_torch.models import DeepLabV3, ESPNetv2Segmentation
from mspl_tpu_torch.utils.flax_bridge import load_flax_variables
from tests.test_torch_model import flax_variables
from tests.test_torch_train import (CLASSES, HW, MODEL_KW, SGD_SCHEDULE,
                                    _batches, _compare_params,
                                    _compare_stats,
                                    _flax_layout, _numpy_tree, _update_gaps)

SCALE = [1.5, 0.5, 2.0, 1.0]
BIAS = [0.1, -0.2, 0.0, 0.3]
MEAN = [0.2, -0.1, 0.0, 0.5]
VAR = [1.2, 0.8, 1.0, 2.0]
DL_KW = dict(stage_blocks=(1, 1, 1, 1), aspp_features=16)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's CPU ops on two threads for this module (see
    tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(seed=1, batch=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, 5, 6, 4)) * 2 + 1).astype(np.float32)


def _port_bn():
    bn = BatchNorm(4)
    with torch.no_grad():
        for t, v in ((bn.weight, SCALE), (bn.bias, BIAS),
                     (bn.running_mean, MEAN), (bn.running_var, VAR)):
            t.copy_(torch.tensor(v))
    return bn.train()


class _Net(nn.Module):
    @nn.compact
    def __call__(self, x):
        return FlaxGhostBN(use_running_average=False, momentum=0.9,
                           epsilon=1e-5)(x)


def _jax_bn(x, groups):
    """The JAX package's ghost-batch BatchNorm in train mode on NHWC `x`:
    (output, mean, var)."""
    v = {"params": {"BatchNorm_0": {"scale": jnp.asarray(SCALE),
                                    "bias": jnp.asarray(BIAS)}},
         "batch_stats": {"BatchNorm_0": {"mean": jnp.asarray(MEAN),
                                         "var": jnp.asarray(VAR)}}}
    with jax_groups(groups):
        y, mut = _Net().apply(v, jnp.asarray(x), mutable=["batch_stats"])
    st = mut["batch_stats"]["BatchNorm_0"]
    return np.asarray(y), np.asarray(st["mean"]), np.asarray(st["var"])


def test_one_group_is_todays_batchnorm():
    """Under `bn_stat_groups(1)` the train output, its gradients and the
    running statistics are those of the BatchNorm outside any context, bit
    for bit (the context's default)."""
    x = torch.from_numpy(_x()).permute(0, 3, 1, 2).contiguous()
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=x.shape).astype(np.float32))
    out = []
    for ctx in (None, 1):
        bn = _port_bn()
        xr = x.clone().requires_grad_()
        if ctx is None:
            y = bn(xr)
        else:
            with bn_stat_groups(ctx):
                y = bn(xr)
        y.backward(g)
        out.append([y.detach(), xr.grad, bn.weight.grad, bn.bias.grad,
                    bn.running_mean, bn.running_var])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("groups", [2, 4])
def test_groups_match_jax(groups):
    """Each contiguous group of 8 / G samples normalized with its own
    statistics: the output within 1e-5 of the JAX package's ghost-batch
    BatchNorm (flax's variance is E[x^2] - E[x]^2, torch's two-pass), the
    running statistics (the mean over the groups at momentum 0.9) within
    1e-6; and not the one-group output."""
    x = _x()
    want_y, want_m, want_v = _jax_bn(x, groups)
    bn = _port_bn()
    with bn_stat_groups(groups), torch.no_grad():
        y = bn(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), want_y,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_m, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), want_v, rtol=1e-6,
                               atol=0)
    one, _, _ = _jax_bn(x, 1)
    assert np.abs(y.permute(0, 2, 3, 1).numpy() - one).max() > 1e-2


def test_indivisible_batch_raises():
    """6 samples in 4 groups raise ValueError, in train; eval takes the
    running statistics whatever the group count."""
    bn = _port_bn()
    x = torch.from_numpy(_x(batch=6)).permute(0, 3, 1, 2).contiguous()
    with bn_stat_groups(4), pytest.raises(ValueError, match="divisible"):
        bn(x)
    bn.eval()
    with torch.no_grad():
        want = bn(x)
        with bn_stat_groups(4):
            assert torch.equal(bn(x), want)


def _jax_ghost_step(model, variables, batch, cw, groups):
    """The JAX package's one SGD step at `bn_groups=groups` on the hybrid
    schedule of tests/test_torch_train.py: (loss, the new tree)."""
    sched = SGD_SCHEDULE
    state = jax_state(model, variables, jax_optimizer("sgd", jax_schedule(
        sched["name"], sched["base_lr"], sched["total_steps"],
        max_lr=sched["max_lr"], cycle_epochs=sched["cycle_epochs"])))
    step = jax_train_step(model, class_weights=cw, augment=False,
                          bn_groups=groups, donate=False)
    state, m = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                    jax.random.PRNGKey(0))
    return float(m["loss"]), _numpy_tree(
        {"params": state.params, "batch_stats": state.batch_stats})


@pytest.mark.parametrize("name", ["espnetv2", "deeplabv3"])
def test_bn_groups_train_step_matches_jax(name):
    """One SGD step at `bn_groups=2` against the JAX package's
    `make_train_step(bn_groups=2)` from one perturbed tree: the loss within
    5e-6 relative (against the port's step in f64, JAX's ghost-batch loss
    is off by 2.1e-6 for ESPNetv2 and 1.2e-6 for DeepLab, the port's by
    4e-8: flax's E[x^2] - E[x]^2 over small groups;
    `python -m tests.torch_rounding_gaps`); ESPNetv2 on a
    batch of 4 with parameters and statistics within `_check_sgd`'s
    first-step bounds; the small DeepLab on a batch of 2 (one sample a
    group: its ASPP image pool sees one value per channel in each) within
    tests/test_torch_train.py's DeepLab bounds (statistics 3e-5, updates
    2e-2 in norm and 0.1 by element)."""
    n = 4 if name == "espnetv2" else 2
    if name == "espnetv2":
        flax_model = FlaxESPNetv2(num_classes=CLASSES,
                                  channel_major_logits=True, **MODEL_KW)
        port = ESPNetv2Segmentation(CLASSES, **MODEL_KW)
    else:
        flax_model = FlaxDeepLab(num_classes=CLASSES, **DL_KW)
        port = DeepLabV3(CLASSES, **DL_KW)
    variables = flax_variables(flax_model, HW, seed=41)
    b = _batches(2)
    batch = {k: np.concatenate([b[0][k], b[1][k]])[:n] for k in b[0]}
    labels = batch["label"]
    cw = compute_class_weights(np.bincount(labels[labels != 255],
                                           minlength=CLASSES))
    want_loss, want_tree = _jax_ghost_step(flax_model, variables, batch,
                                           cw, 2)
    load_flax_variables(port, variables)
    start = {n: t.detach().clone() for n, t in port.named_parameters()}
    state = create_train_state(port, "sgd", build_schedule(
        "hybrid", 0.005, 6, max_lr=0.01, cycle_epochs=3), device="cpu")
    step = make_train_step(port, class_weights=cw, augment=False,
                           bn_groups=2, device="cpu")
    state, m = step(state, batch)
    ref = _flax_layout(want_tree, port)
    np.testing.assert_allclose(m["loss"].item(), want_loss, rtol=5e-6)
    if name == "espnetv2":
        _compare_params(port, ref, "after the step", 1e-6, 1e-5)
        _compare_stats(port, ref, "after the step", 1e-5)
        return
    _compare_stats(port, ref, "after the step", 3e-5)
    for key, (norm_gap, elem_gap) in _update_gaps(port, ref, start).items():
        assert norm_gap <= 2e-2 and elem_gap <= 0.1, (key, norm_gap,
                                                      elem_gap)
