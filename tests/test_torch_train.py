"""The port's train slice against the JAX package at fp32 on the CPU, from
one perturbed flax variable tree: the train-mode forward (channel-major
logits and the updated BatchNorm statistics), the loss and every gradient
at init, 3 SGD and 2 AdamW steps through `make_train_step(augment=False)`
(loss per step, then parameters and BatchNorm statistics after each
step), one step of each at a weight decay large enough to show, the eval step's confusion matrix and mIoU, and the RGB-D model.

Parameters and gradients are compared in the flax layout: a JAX tree
(the new state, or the gradients as a "params" tree) is loaded into a
second port model and compared with the port's tensors by name.  fp32
trajectories of the two frameworks agree to ~1e-6 relative at step 0 and
drift apart with every step (sums in another order), so the bounds are
per quantity and step, each stated where it is checked.  The JAX programs
are compiled once, in the module fixture."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data.transforms import normalize as jax_normalize
from mspl_tpu.engine.losses import segmentation_loss as jax_loss
from mspl_tpu.engine.schedules import build_schedule as jax_schedule
from mspl_tpu.engine.train import build_optimizer as jax_optimizer
from mspl_tpu.engine.train import create_train_state as jax_state
from mspl_tpu.engine.train import evaluate as jax_evaluate
from mspl_tpu.engine.train import make_eval_step as jax_eval_step
from mspl_tpu.engine.train import make_train_step as jax_train_step
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu_torch.data.transforms import normalize
from mspl_tpu_torch.engine.losses import (compute_class_weights,
                                          segmentation_loss)
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import (create_train_state, evaluate,
                                         make_eval_step, make_train_step)
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.utils.flax_bridge import load_flax_variables
from tests.test_torch_model import _plain_dicts, flax_variables

HW = (32, 48)
BATCH = 2
CLASSES = 5
MODEL_KW = dict(s=0.5, dec_base_planes=8)
# lr schedules of the two optimizers: hybrid (0.005 up to 0.01 and back
# over a cycle of 3, then linear decay), so each update's lr differs, and
# AdamW at a fixed 1e-4
SGD_SCHEDULE = dict(name="hybrid", base_lr=0.005, total_steps=6,
                    max_lr=0.01, cycle_epochs=3)
ADAM_SCHEDULE = dict(name="fixed", base_lr=1e-4, total_steps=2)
# weight decays large enough that the decay's move in the first step (lr *
# wd * |p|: 5e-4 |p| for SGD, 1e-4 |p| for AdamW) is 10x and more beyond
# the step tests' bounds, so that a decay dropped or coupled into Adam's
# moments fails.  One step each: at these decays JAX's own fp32 gradients
# at the second step are off its f64 ones by up to 12% of a tensor's
# largest element (6.3e-2 at level2_0's dw_d0_kernel; the port's are within
# 1e-5 of an f64 port), so the order of decay and momentum trace, which
# shows from the second step on, is held in
# tests/test_torch_engine.py::test_optimizer_matches_optax
DECAY = {"sgd": 0.1, "adam": 1.0}


def _batches(n, seed=7):
    """`n` batches of uint8 images and labels with ~10% ignore (255)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, CLASSES, (BATCH, *HW)).astype(np.int32)
        labels[rng.random(labels.shape) < 0.1] = 255
        out.append({"image": rng.integers(0, 256, (BATCH, *HW, 3),
                                          dtype=np.uint8),
                    "label": labels})
    return out


def _numpy_tree(tree):
    return _plain_dicts(jax.tree_util.tree_map(np.array, tree))


def _trajectory(model, variables, batches, cw, schedule, optimizer, steps,
                weight_decay=4e-5):
    """The JAX train step's loss and (params, batch_stats) after each
    step."""
    sched = jax_schedule(schedule["name"], schedule["base_lr"],
                         schedule["total_steps"],
                         **{k: v for k, v in schedule.items()
                            if k not in ("name", "base_lr", "total_steps")})
    state = jax_state(model, variables, jax_optimizer(
        optimizer, sched, weight_decay=weight_decay))
    step = jax_train_step(model, class_weights=cw, augment=False,
                          donate=False)
    out = []
    for i in range(steps):
        state, metrics = step(state, jax.tree_util.tree_map(
            jnp.asarray, batches[i]), jax.random.PRNGKey(i))
        out.append((float(metrics["loss"]), _numpy_tree(
            {"params": state.params, "batch_stats": state.batch_stats})))
    return out


@pytest.fixture(scope="module")
def case():
    model = FlaxESPNetv2(num_classes=CLASSES, channel_major_logits=True,
                         **MODEL_KW)
    variables = flax_variables(model, HW, seed=11)
    batches = _batches(3)
    b0 = batches[0]
    hist = np.bincount(b0["label"][b0["label"] != 255], minlength=CLASSES)
    cw = compute_class_weights(hist)

    def loss_fn(params, imgs, labels):
        out, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jax_normalize(imgs), train=True, mutable=["batch_stats"])
        loss = jax_loss(out, labels, class_weights=jnp.asarray(cw),
                        channel_axis=1)
        return loss, (out, mutated["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"], jnp.asarray(b0["image"]),
                                jnp.asarray(b0["label"]))
    init = dict(loss=float(loss), logits=np.asarray(logits),
                stats=_numpy_tree(stats), grads=_numpy_tree(grads))

    sgd = _trajectory(model, variables, batches, cw, SGD_SCHEDULE, "sgd", 3)
    adam = _trajectory(model, variables, batches, cw, ADAM_SCHEDULE, "adam",
                       2)
    decayed = {opt: _trajectory(model, variables, batches, cw, sched, opt,
                                steps, weight_decay=DECAY[opt])
               for opt, sched, steps in (("sgd", SGD_SCHEDULE, 1),
                                         ("adam", ADAM_SCHEDULE, 1))}
    iou, miou = jax_evaluate(jax_eval_step(model, CLASSES),
                             variables["params"], variables["batch_stats"],
                             [jax.tree_util.tree_map(jnp.asarray, b)
                              for b in batches], CLASSES)
    return dict(variables=variables, batches=batches, cw=cw, init=init,
                sgd=sgd, adam=adam, decayed=decayed, eval=(iou, miou))


def _port(variables, **kw):
    port = ESPNetv2Segmentation(CLASSES, **MODEL_KW, **kw)
    load_flax_variables(port, variables)
    return port


def _flax_layout(tree, like):
    """A port model holding the flax `tree` (its params and batch_stats)."""
    ref = copy.deepcopy(like)
    load_flax_variables(ref, tree)
    return ref


def _compare_params(port, ref, what, atol, rtol):
    """Every parameter within atol + rtol * |ref|."""
    ref_p = dict(ref.named_parameters())
    for name, t in port.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(),
                                   ref_p[name].detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what}: {name}")


def _compare_stats(port, ref, what, atol_s):
    """Every running mean within atol_s, every running variance within
    atol_s relative."""
    ref_b = dict(ref.named_buffers())
    for name, t in port.named_buffers():
        if name.endswith("running_mean"):
            np.testing.assert_allclose(t.numpy(), ref_b[name].numpy(),
                                       rtol=0, atol=atol_s,
                                       err_msg=f"{what}: {name}")
        elif name.endswith("running_var"):
            np.testing.assert_allclose(t.numpy(), ref_b[name].numpy(),
                                       rtol=atol_s, atol=0,
                                       err_msg=f"{what}: {name}")


def test_train_forward_matches_flax(case):
    """Train-mode logits (channel-major) and the updated BatchNorm
    statistics: f32 batch statistics summed in another order, logits
    within 1e-4 (|logits| up to ~10), statistics within 1e-5."""
    port = _port(case["variables"]).train()
    b0 = case["batches"][0]
    with torch.no_grad():
        got = port(normalize(torch.from_numpy(b0["image"]))).numpy()
    want = case["init"]["logits"]
    assert got.shape == want.shape == (BATCH, CLASSES, *HW)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(1) == want.argmax(1)).all()
    ref = _flax_layout({"params": case["variables"]["params"],
                        "batch_stats": case["init"]["stats"]}, port)
    _compare_stats(port, ref, "batch_stats", 1e-5)


def test_gradients_at_init_match_jax(case):
    """Loss within 1e-6 relative; each gradient tensor within 2e-3 of
    JAX's in norm, and each element within 5e-3 of its tensor's largest
    |gradient|.  The gap is fp32 noise of both frameworks (sums in another
    order through the whole backward; JAX's BatchNorm differentiates
    mean(x^2) - mean(x)^2): measured 6.7e-4 in norm and 1.0e-3 by element
    at most, while against the same JAX model in f64 JAX's fp32 gradients
    are off by 9e-5 (median) to 5e-4 (max) in norm, the port's by 4.5e-5
    to 1.4e-4."""
    port = _port(case["variables"]).train()
    b0 = case["batches"][0]
    loss = segmentation_loss(
        port(normalize(torch.from_numpy(b0["image"]))),
        torch.from_numpy(b0["label"]),
        class_weights=torch.from_numpy(case["cw"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), case["init"]["loss"], rtol=1e-6)
    ref = _flax_layout({"params": case["init"]["grads"],
                        "batch_stats": case["variables"]["batch_stats"]},
                       port)
    ref_p = dict(ref.named_parameters())
    for name, t in port.named_parameters():
        assert t.grad is not None, f"{name} has no gradient"
        got, want = t.grad.numpy(), ref_p[name].detach().numpy()
        assert np.abs(want).max() > 0, name
        gap = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert gap <= 2e-3, f"{name}: relative gap {gap:.3g} in norm"
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-3 * np.abs(want).max(),
                                   err_msg=name)


def _run_steps(case, optimizer, schedule, check, trajectory=None,
               weight_decay=4e-5):
    """The port's `make_train_step` from the case's tree, one step per
    batch of the JAX `trajectory` (by default the case's of `optimizer`);
    `check(i, port, ref)` after each step, `ref` a port model holding the
    JAX state."""
    port = _port(case["variables"])
    sched = build_schedule(schedule["name"], schedule["base_lr"],
                           schedule["total_steps"],
                           **{k: v for k, v in schedule.items()
                              if k not in ("name", "base_lr", "total_steps")})
    state = create_train_state(port, optimizer, sched,
                               weight_decay=weight_decay, device="cpu")
    step = make_train_step(port, class_weights=case["cw"], augment=False,
                           device="cpu")
    for i, (want_loss, want_tree) in enumerate(
            trajectory or case[optimizer]):
        state, metrics = step(state, case["batches"][i])
        assert state.step == i + 1
        check(i, metrics["loss"].item(), want_loss, port,
              _flax_layout(want_tree, port))


def _check_sgd(i, loss, want_loss, port, ref):
    """SGD step i: bounds that grow ~10x a step, as two fp32 trajectories
    drift apart: loss 10^(i-6) relative, parameters 10^(i-6) + 10^(i-5)
    relative, statistics 10^(i-5)."""
    tol = 10.0 ** (i - 6)
    np.testing.assert_allclose(loss, want_loss, rtol=tol,
                               err_msg=f"step {i} loss")
    _compare_params(port, ref, f"after step {i}", tol, 10 * tol)
    _compare_stats(port, ref, f"after step {i}", 10 * tol)


def _check_adam(lr):
    """AdamW step i: loss within 10^(i-6) relative; statistics as SGD's;
    every parameter within 1e-6 + 1e-5 relative, but for at most 0.1% of
    the elements, which stay within Adam's largest move, 2 * lr a step."""
    def check(i, loss, want_loss, port, ref):
        np.testing.assert_allclose(loss, want_loss, rtol=10.0 ** (i - 6),
                                   err_msg=f"step {i} loss")
        _compare_stats(port, ref, f"after step {i}", 10.0 ** (i - 5))
        ref_p = dict(ref.named_parameters())
        off = total = 0
        for name, t in port.named_parameters():
            got, want = t.detach().numpy(), ref_p[name].detach().numpy()
            gap = np.abs(got - want)
            off += int((gap > 1e-6 + 1e-5 * np.abs(want)).sum())
            total += gap.size
            assert gap.max() <= 2 * lr * (i + 1), name
        assert off <= 1e-3 * total, f"step {i}: {off} of {total} off"
    return check


def test_sgd_steps_match_jax(case):
    """3 SGD steps (momentum 0.9, weight decay 4e-5, hybrid lr) against the
    JAX package's train step: the loss each step, then every parameter and
    running statistic after it, within `_check_sgd`'s bounds: loss 1e-6,
    1e-5, 1e-4 relative (measured 3.8e-7, 1.2e-7, 9.6e-7); parameters
    1e-6, 1e-5, 1e-4 + 10x that relative (measured 3.8e-7, 1.2e-6, 1.0e-5
    at most); statistics 1e-5, 1e-4, 1e-3 (measured 2.9e-7, 9.8e-7, 2.9e-6
    on the means, 2.8e-6, 5.1e-6, 2.0e-5 relative on the variances)."""
    _run_steps(case, "sgd", SGD_SCHEDULE, _check_sgd)


def test_adamw_steps_match_jax(case):
    """2 AdamW steps (lr 1e-4, weight decay 4e-5) within `_check_adam`'s
    bounds.  The elements allowed off are those whose gradient lies at fp32
    noise (|g| ~ 1e-8), which Adam scales up to +-lr whatever its sign
    (measured: 14 and 17 of 73,103 elements, in grouped 1x1 weights of the
    2x3-pixel stage 4)."""
    _run_steps(case, "adam", ADAM_SCHEDULE,
               _check_adam(ADAM_SCHEDULE["base_lr"]))


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_weight_decay_steps_match_jax(case, optimizer):
    """One SGD step at weight decay 0.1 and one AdamW step at 1.0 against
    the JAX package's train step (optax's `add_decayed_weights` -> `sgd`,
    and `adamw`), within the bounds of the first step at 4e-5; the decay
    moves each parameter by 5e-4 |p| (SGD) and 1e-4 |p| (AdamW)."""
    check = (_check_sgd if optimizer == "sgd"
             else _check_adam(ADAM_SCHEDULE["base_lr"]))
    _run_steps(case, optimizer,
               SGD_SCHEDULE if optimizer == "sgd" else ADAM_SCHEDULE, check,
               trajectory=case["decayed"][optimizer],
               weight_decay=DECAY[optimizer])


def test_eval_step_miou_matches_jax(case):
    """Confusion matrices over three batches: identical counts (logits
    agree to ~1e-6, and no pixel of these batches is that close to a
    tie), so equal per-class IoU and mIoU."""
    port = _port(case["variables"])
    iou, miou = evaluate(make_eval_step(port, CLASSES, device="cpu"),
                         case["batches"],
                         CLASSES)
    want_iou, want_miou = case["eval"]
    np.testing.assert_array_equal(iou, want_iou)
    assert miou == want_miou


def test_rgbd_model_matches_flax():
    """A 4-channel stem (level1 and each DownSampler's reinforcement) from
    a flax tree initialized on 4-channel images: eval logits within 1e-4,
    argmax equal."""
    model = FlaxESPNetv2(num_classes=CLASSES, channel_major_logits=True,
                         **MODEL_KW)
    variables = flax_variables(model, HW, seed=12, channels=4)
    stem = variables["params"]["base_net"]["level1"]["CB_0"]["C_0"]
    assert stem["Conv_0"]["kernel"].shape[2] == 4
    img = np.random.default_rng(13).integers(0, 256, (BATCH, *HW, 4),
                                             dtype=np.uint8)
    want = np.asarray(jax.jit(lambda v, a: model.apply(
        v, jax_normalize(a), train=False))(variables, jnp.asarray(img)))
    port = _port(variables, in_channels=4)
    with torch.no_grad():
        got = port(normalize(torch.from_numpy(img))).numpy()
    assert got.shape == want.shape == (BATCH, CLASSES, *HW)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(1) == want.argmax(1)).all()
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(ESPNetv2Segmentation(CLASSES, **MODEL_KW),
                            variables)
