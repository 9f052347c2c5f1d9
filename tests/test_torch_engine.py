"""The port's train-side pieces against the JAX package, at fp32 (and bf16
for BatchNorm) on the CPU: train-mode BatchNorm and its running statistics,
the segmentation loss and its gradient, the confusion matrix and mIoU, the
lr schedules, the optimizers against optax's, the engine's default device,
and the branch stack's autograd Function (its backward
against `jax.vjp` of the jnp reference, as the TPU kernel's custom VJP
computes it).  Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mspl_tpu.engine.losses import segmentation_loss as jax_loss
from mspl_tpu.engine.metrics import MIOU as JaxMIOU
from mspl_tpu.engine.metrics import confusion_matrix as jax_confusion
from mspl_tpu.engine.metrics import iou_from_confusion as jax_iou
from mspl_tpu.engine.schedules import build_schedule as jax_schedule
from mspl_tpu.engine.train import build_optimizer as jax_optimizer
from mspl_tpu.layers.bn import BatchNorm as FlaxBatchNorm
from mspl_tpu.ops.pallas_pyrpool import pyr_branches_jnp
from mspl_tpu_torch.engine.losses import (compute_class_weights,
                                          segmentation_loss)
from mspl_tpu_torch.engine.metrics import (MIOU, confusion_matrix,
                                           iou_from_confusion)
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import (build_optimizer,
                                         create_train_state, make_eval_step,
                                         make_train_step)
from mspl_tpu_torch.layers.conv_blocks import BatchNorm
from mspl_tpu_torch.ops import pyrpool

SCALES = (2.0, 1.5, 1.0, 0.5, 0.1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1,
                                                                  2))))


# --- train-mode BatchNorm -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batchnorm_matches_flax(dtype):
    """Output and running statistics after one train call.  f32: 1e-5 (the
    two sum the batch statistics in another order); bf16: the output
    within one bf16 rounding (2^-8 relative, both compute in f32 and round
    once), the statistics (f32 in both) within 1e-5."""
    rng = np.random.default_rng(0)
    c = 6
    x = (rng.normal(0.5, 2.0, (3, 7, 9, c))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj = jnp.asarray(x).astype(jdt)
    bn = FlaxBatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jdt)
    want, mutated = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        xj, mutable=["batch_stats"])
    port = BatchNorm(c).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    got = port(_nchw(np.asarray(xj.astype(jnp.float32))).to(tdt))
    assert got.dtype == tdt
    want = np.transpose(np.asarray(want.astype(jnp.float32)), (0, 3, 1, 2))
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=2.0 ** -8, atol=1e-6)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5, atol=0)


# --- segmentation loss ----------------------------------------------------

def _loss_case(seed=2, c=5):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2.0, (3, c, 8, 12)).astype(np.float32)
    labels = rng.integers(0, c, (3, 8, 12)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.15] = 255
    hist = np.bincount(labels[labels != 255], minlength=c)
    return logits, labels, compute_class_weights(hist)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "batch_mask"])
@pytest.mark.parametrize("reg_mode", ["none", "kld", "ent"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "class_weights"])
def test_segmentation_loss_matches_jax(weighted, reg_mode, masked):
    """Loss and its gradient in the logits against the JAX loss
    (channel_axis=1): f32 sums in another order, rtol 1e-6 on the loss and
    atol 1e-8 on the gradient (whose entries are ~1/pixels)."""
    logits, labels, cw = _loss_case()
    mask = np.array([True, False, True]) if masked else None
    kw = dict(reg_mode=reg_mode, reg_weight=0.3 if reg_mode != "none" else 0.0)

    def jfn(lg):
        return jax_loss(lg, jnp.asarray(labels),
                        class_weights=jnp.asarray(cw) if weighted else None,
                        batch_mask=None if mask is None else jnp.asarray(mask),
                        channel_axis=1, **kw)

    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = segmentation_loss(
        lt, torch.from_numpy(labels),
        class_weights=torch.from_numpy(cw) if weighted else None,
        batch_mask=None if mask is None else torch.from_numpy(mask), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-8)


def test_class_weights_match_jax():
    from mspl_tpu.engine.losses import compute_class_weights as jax_cw

    hist = np.array([1000, 10, 0, 250, 3])
    np.testing.assert_array_equal(compute_class_weights(hist), jax_cw(hist))


# --- metrics --------------------------------------------------------------

def _metric_case(seed=3, c=6):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, c + 2, (4, 9, 11)).astype(np.int32)  # clamped
    label = rng.integers(0, c, (4, 9, 11)).astype(np.int32)
    label[rng.random(label.shape) < 0.1] = 255
    return pred, label


@pytest.mark.parametrize("masked", [False, True], ids=["all", "batch_mask"])
def test_confusion_matrix_matches_jax(masked):
    """Counts are integers below 2^24: exact."""
    pred, label = _metric_case()
    mask = np.array([True, True, False, True]) if masked else None
    want = np.asarray(jax_confusion(
        jnp.asarray(pred), jnp.asarray(label), 6,
        batch_mask=None if mask is None else jnp.asarray(mask)))
    got = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), 6,
                           batch_mask=None if mask is None
                           else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (6, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum().item() == (label != 255)[
        mask if masked else slice(None)].sum()


def test_iou_and_streaming_miou_match_jax():
    """Per-class IoU (nan for absent classes) and mIoU over two batches."""
    pred, label = _metric_case(seed=4)
    label[label == 2] = 255  # class 2 absent from the labels
    pred[pred == 2] = 0      # ... and from the predictions: nan IoU
    cm = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), 6)
    want = jax_iou(np.asarray(jax_confusion(jnp.asarray(pred),
                                            jnp.asarray(label), 6)))
    got = iou_from_confusion(cm.numpy())
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    port, ref = MIOU(6), JaxMIOU(6)
    for half in (slice(0, 2), slice(2, 4)):
        port.update_preds(pred[half], label[half])
        ref.update_preds(pred[half], label[half])
    np.testing.assert_array_equal(port.get_iou()[0], ref.get_iou()[0])
    assert port.get_iou()[1] == ref.get_iou()[1]


# --- schedules ------------------------------------------------------------

STEPS = (0, 1, 2, 3, 4, 5, 7, 9, 10, 11, 13, 19, 20, 25)


@pytest.mark.parametrize("name,kw", [
    ("poly", {}), ("poly", dict(power=2.0)), ("step", dict(step_epochs=3)),
    ("cyclic", dict(cycle_epochs=2)), ("cyclic", dict(cycle_epochs=1)),
    ("hybrid", {}), ("hybrid", dict(cycle_epochs=1, cycle_frac=0.3)),
    ("linear", {}), ("fixed", {})])
def test_schedule_matches_jax(name, kw):
    """At steps before, across and past the schedule's end; optax computes
    in f32, the port in f64: rtol 1e-6."""
    want_fn = jax_schedule(name, 0.009, 20, steps_per_epoch=2, **kw)
    got_fn = build_schedule(name, 0.009, 20, steps_per_epoch=2, **kw)
    for step in STEPS:
        np.testing.assert_allclose(got_fn(step), float(want_fn(step)),
                                   rtol=1e-6, atol=1e-12,
                                   err_msg=f"{name} step {step}")


@pytest.mark.parametrize("name,wd", [("sgd", 0.1), ("adam", 1.0)])
def test_optimizer_matches_optax(name, wd):
    """3 updates of `build_optimizer`'s optimizer against the JAX package's
    optax chain (`add_decayed_weights` -> `sgd`, or `adamw`) from the same
    parameters and gradients, at the hybrid lr that each update sets, as
    the train step does: within 5e-7 + 1e-6 relative (against an f64
    AdamW over these 3 updates, optax's f32 parameters are off by up to
    2.2e-7, torch's by 1.6e-7; SGD agrees exactly).  The parameters have
    the model's ranks (a conv kernel, a BatchNorm scale, a PReLU slope) and
    the decay is large enough to show: it moves a parameter by lr * wd *
    |p| ~ 2.5e-4 (SGD) and 2.5e-3 (AdamW) an update, and a decay added
    after the momentum trace would differ by 0.9 of that from the second
    update on."""
    rng = np.random.default_rng(3)
    shapes = ((8, 4, 3, 3), (8,), (8,))
    params = [rng.normal(0, 0.5, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1, s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    kw = dict(max_lr=0.01, cycle_epochs=3)
    tx = jax_optimizer(name, jax_schedule("hybrid", 0.005, 6, **kw),
                       weight_decay=wd)
    want = [jnp.asarray(p) for p in params]
    opt_state = tx.init(want)
    sched = build_schedule("hybrid", 0.005, 6, **kw)
    got = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = build_optimizer(name, got, sched, weight_decay=wd)
    for n, g in enumerate(grads):
        updates, opt_state = tx.update([jnp.asarray(a) for a in g],
                                       opt_state, want)
        want = optax.apply_updates(want, updates)
        for t, a in zip(got, g):
            t.grad = torch.from_numpy(a.copy())
        for group in opt.param_groups:
            group["lr"] = sched(n)
        opt.step()
        for i, (t, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=5e-7,
                                       err_msg=f"update {n}, tensor {i}")


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="scheduler"):
        build_schedule("cosine", 0.1, 10)
    with pytest.raises(ValueError, match="optimizer"):
        build_optimizer("lamb", [torch.zeros(1, requires_grad=True)],
                        lambda s: 0.1)
    # augmentation is in (the self-training slice); it needs a crop size
    with pytest.raises(ValueError, match="crop_hw"):
        make_train_step(torch.nn.Linear(1, 1), augment=True, device="cpu")


@pytest.mark.parametrize("entry", ["state", "train_step", "eval_step"])
def test_engine_entry_points_default_to_the_card(entry):
    """Without `device`, each entry point moves the model to the card: where
    torch has no CUDA it raises rather than train or evaluate on the CPU;
    `device="cpu"` keeps it there."""
    calls = {"state": lambda m, **kw: create_train_state(
                 m, "sgd", lambda s: 0.1, **kw),
             "train_step": lambda m, **kw: make_train_step(m, **kw),
             "eval_step": lambda m, **kw: make_eval_step(m, 2, **kw)}
    model = torch.nn.Linear(1, 1)
    calls[entry](model, device="cpu")
    assert model.weight.device.type == "cpu"
    if torch.cuda.is_available():
        calls[entry](model)
        assert model.weight.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            calls[entry](model)


# --- the branch stack's autograd Function ---------------------------------

@pytest.fixture(scope="module")
def branch_case():
    """x [B, P, H, W], weights [S, 3, 3, P], an upstream gradient, and
    the JAX forward and VJP of the jnp reference."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 8, 9, 14)).astype(np.float32)
    w = rng.normal(0, 0.5, (5, 3, 3, 8)).astype(np.float32)
    g = rng.normal(0, 1, (2, 40, 9, 14)).astype(np.float32)
    xh = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    out, vjp = jax.vjp(lambda a, b: pyr_branches_jnp(a, b, SCALES), xh,
                       jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(np.transpose(g, (0, 2, 3, 1))))
    want = (np.transpose(np.asarray(out), (0, 3, 1, 2)),
            np.transpose(np.asarray(gx), (0, 3, 1, 2)), np.asarray(gw))
    return x, w, g, want


@pytest.mark.parametrize("route", ["function", "cpu_plain"])
def test_pyr_branches_backward_matches_jax_vjp(branch_case, route,
                                               monkeypatch):
    """`function`: the autograd Function that CUDA tensors take, with the
    kernel's launch stood in by the plain version (the card holds the
    kernel against it); its backward recomputes the plain version.
    `cpu_plain`: what CPU tensors take, autograd through the plain
    version.  f32 sums in another order: atol 1e-5."""
    x, w, g, (want, want_gx, want_gw) = branch_case
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    if route == "function":
        monkeypatch.setattr(pyrpool, "_launch_branches",
                            pyrpool.pyr_branches_plain)
        out = pyrpool._PyrBranches.apply(xt, wt, SCALES)
    else:
        out = pyrpool.pyr_branches(xt, wt, SCALES)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), want_gw, rtol=0, atol=1e-4)
    assert pyrpool.pyr_branches.launches == 0


def test_pyr_branches_function_grads_only_what_is_asked(branch_case,
                                                        monkeypatch):
    """The Function returns a gradient only for the inputs that need one."""
    x, w, g, (_, want_gx, _) = branch_case
    monkeypatch.setattr(pyrpool, "_launch_branches",
                        pyrpool.pyr_branches_plain)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w)
    pyrpool._PyrBranches.apply(xt, wt, SCALES).backward(torch.from_numpy(g))
    assert wt.grad is None
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=0, atol=1e-5)
