"""The port's encoder-pretraining slice against the JAX package on the CPU:
the `EESPNet` classifier's eval forward (default, `use_pallas` and
`fuse_stages` routes, whose kernels take their plain versions here) from
one perturbed flax tree; its variable tree both ways; one SGD and one
AdamW `make_cls_train_step` step at drop rate 0, and a batch-1 step whose
level5 BatchNorm sees one value per channel; dropout; the eval step's
counts on a padded batch; a tiny `train_classification` that learns; and
the pretrained encoder's transfer into a segmentation model, on trees and
on modules.  The step bounds are tests/test_torch_train.py's first-step
bounds (`_check_sgd`, `_check_adam`)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data.loader import DataLoader as JaxDataLoader
from mspl_tpu.data.transforms import normalize as jax_normalize
from mspl_tpu.engine import train_cls as jax_cls
from mspl_tpu.engine.schedules import build_schedule as jax_schedule
from mspl_tpu.engine.train import build_optimizer as jax_optimizer
from mspl_tpu.engine.train import create_train_state as jax_state
from mspl_tpu.models import EESPNet as FlaxEESPNet
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu_torch.data.loader import DataLoader
from mspl_tpu_torch.data.transforms import normalize
from mspl_tpu_torch.engine import train_cls
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import create_train_state
from mspl_tpu_torch.models import EESPNet, ESPNetv2Segmentation, init_model
from mspl_tpu_torch.models.espnetv2 import copy_encoder, dropout
from mspl_tpu_torch.ops.eesp_branches import eesp_branches
from mspl_tpu_torch.ops.eesp_stage import eesp_stage_fused_eval
from mspl_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables)
from tests.test_cls import ColorClassDataset
from tests.test_torch_model import flax_variables as perturbed_tree
from tests.test_torch_train import (_check_adam, _check_sgd,
                                    _compare_stats, _flax_layout,
                                    _numpy_tree, _update_gaps)

HW = (32, 32)
# the train steps' batch of 4: at 32x32 level5's 1x1 planes give its train
# BatchNorm 4 values a channel, where fp32 rounding moves the loss by
# 5.0e-5 (port) and 6.4e-5 (JAX) relative to the port's f64 forward; at
# 64x64, 16 values, 2.8e-7 and 4.8e-7 (`python -m tests.torch_rounding_gaps`)
STEP_HW = (64, 64)
CLASSES = 10
SCHEDULES = {"sgd": dict(name="hybrid", base_lr=0.005, total_steps=6,
                         max_lr=0.01, cycle_epochs=3),
             "adam": dict(name="fixed", base_lr=1e-4, total_steps=2)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's CPU ops on two threads for this module: the tests run in
    several workers on one host, where small ops on as many threads as
    cores mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(n, seed, hw=HW):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


def _port(variables, s, **kw):
    model = EESPNet(s=s, num_classes=CLASSES, **kw)
    load_flax_variables(model, variables)
    return model


@pytest.fixture(scope="module", params=[0.5, 2.0], ids=["s0.5", "s2.0"])
def forward_case(request):
    """A perturbed tree of the JAX classifier at width `s` and its eval
    logits on a batch of 2."""
    s = request.param
    model = FlaxEESPNet(s=s, num_classes=CLASSES)
    variables = perturbed_tree(model, HW, seed=31)
    img = _images(2, seed=32)
    want = np.asarray(jax.jit(lambda v, a: model.apply(
        v, jax_normalize(a), train=False))(variables, jnp.asarray(img)))
    return s, variables, img, want


@pytest.mark.parametrize("route", ["default", "use_pallas", "fuse_stages"])
def test_classifier_eval_matches_flax(forward_case, route):
    """Eval logits [2, 10] within 1e-4 of the flax classifier's, argmax
    equal, through each encoder route (the kernels' plain versions on the
    CPU: no launch)."""
    s, variables, img, want = forward_case
    kw = {} if route == "default" else {route: True}
    port = _port(variables, s, **kw)
    before = (eesp_branches.launches, eesp_stage_fused_eval.launches)
    with torch.no_grad():
        got = port(normalize(torch.from_numpy(img))).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2,
                                                                   CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert (eesp_branches.launches, eesp_stage_fused_eval.launches) == before


def test_classifier_tree_round_trips(forward_case):
    """Every leaf of the flax classifier's tree loads (no tensor of the
    port is left out) and comes back bit for bit; a segmentation model's
    encoder is the classifier's without level5 and the head."""
    s, variables, _, _ = forward_case
    port = EESPNet(s=s, num_classes=CLASSES)
    with torch.no_grad():
        for t in port.state_dict().values():
            if t.is_floating_point():
                t.fill_(float("nan"))
    load_flax_variables(port, variables)
    for k, t in port.state_dict().items():
        if t.is_floating_point():
            assert torch.isfinite(t).all(), k
    back = flax_variables(port)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    seg = ESPNetv2Segmentation(3, s=s).base_net.state_dict()
    assert set(seg) == {k for k in port.state_dict()
                        if not k.startswith(("level5", "classifier"))}


@pytest.fixture(scope="module")
def step_case():
    """From one perturbed s=0.5 tree at drop rate 0: the JAX package's
    `make_cls_train_step` after one SGD and one AdamW step on a batch of 4
    at `STEP_HW`, and one SGD step on a batch of 1 at 32x32."""
    model = FlaxEESPNet(s=0.5, num_classes=CLASSES, drop_rate=0.0)
    variables = perturbed_tree(model, HW, seed=33)
    labels = np.random.default_rng(35).integers(0, CLASSES, 4).astype(
        np.int32)
    batches = {4: {"image": _images(4, 34, STEP_HW), "label": labels},
               1: {"image": _images(1, 34), "label": labels[:1]}}
    step = jax_cls.make_cls_train_step(model)
    out = {"variables": variables, "batches": batches}
    for opt, n in (("sgd", 4), ("adam", 4), ("sgd", 1)):
        sched = SCHEDULES[opt]
        tx = jax_optimizer(opt, jax_schedule(
            sched["name"], sched["base_lr"], sched["total_steps"],
            **{k: v for k, v in sched.items()
               if k not in ("name", "base_lr", "total_steps")}))
        state, m = step(jax_state(model, variables, tx),
                        jax.tree_util.tree_map(jnp.asarray, batches[n]),
                        jax.random.PRNGKey(0))
        out[(opt, n)] = (float(m["loss"]), float(m["acc"]), _numpy_tree(
            {"params": state.params, "batch_stats": state.batch_stats}))
    return out


@pytest.mark.parametrize("opt,n", [("sgd", 4), ("adam", 4), ("sgd", 1)],
                         ids=["sgd", "adam", "sgd-batch1"])
def test_cls_train_step_matches_jax(step_case, opt, n):
    """One step of the port's `make_cls_train_step` against the JAX
    package's from the same tree at drop rate 0: the loss, the accuracy
    (equal), every parameter and statistic within the bounds of
    tests/test_torch_train.py.  AdamW and the batch-1 SGD step take its
    first-step bounds (`_check_adam`, `_check_sgd`).  The batch-4 SGD step
    takes the bounds of its DeepLab step (loss and statistics within 1e-5,
    each update within 2e-2 of JAX's in norm and 0.1 of its largest
    element), since its fp32 gradients are as noisy: against the port's
    step in f64, JAX's updates are off by up to 6.0e-3 in norm and 1.0e-2
    by element (`level2_0`'s reinforcement BatchNorm bias), the port's by
    3.1e-4 and 4.6e-4, at 1, 2, 4 and 8 threads
    (`python -m tests.torch_rounding_gaps`).  At batch 1 (32x32)
    level5 runs on 1x1 planes, where its train BatchNorm sees one value
    per channel."""
    want_loss, want_acc, want_tree = step_case[(opt, n)]
    port = _port(step_case["variables"], 0.5, drop_rate=0.0)
    start = {k: t.detach().clone() for k, t in port.named_parameters()}
    sched = SCHEDULES[opt]
    state = create_train_state(port, opt, build_schedule(
        sched["name"], sched["base_lr"], sched["total_steps"],
        **{k: v for k, v in sched.items()
           if k not in ("name", "base_lr", "total_steps")}), device="cpu")
    step = train_cls.make_cls_train_step(port, device="cpu")
    state, m = step(state, step_case["batches"][n],
                    torch.Generator().manual_seed(0))
    assert state.step == 1 and port.training
    assert m["acc"].item() == want_acc
    ref = _flax_layout(want_tree, port)
    if opt == "adam":
        _check_adam(SCHEDULES["adam"]["base_lr"])(0, m["loss"].item(),
                                                  want_loss, port, ref)
    elif n == 1:
        _check_sgd(0, m["loss"].item(), want_loss, port, ref)
    else:
        np.testing.assert_allclose(m["loss"].item(), want_loss, rtol=1e-5)
        _compare_stats(port, ref, "after the step", 1e-5)
        for name, gaps in _update_gaps(port, ref, start).items():
            assert gaps[0] <= 2e-2 and gaps[1] <= 0.1, (name, gaps)


def test_dropout_keeps_and_scales_from_its_generator():
    """Each element kept with probability 1 - p (within 4 standard
    deviations of the binomial) and scaled by 1 / (1 - p), the rest 0; the
    same generator seed draws the same mask, another seed another; a
    train forward at drop rate p > 0 needs a generator, and one from a
    seed gives the same logits twice."""
    p, n = 0.2, 100_000
    x = torch.rand(n) + 1.0
    y = dropout(x, p, torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) <= 4 * np.sqrt(
        p * (1 - p) / n)
    torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=0, atol=0)
    assert torch.equal(y, dropout(x, p, torch.Generator().manual_seed(1)))
    assert not torch.equal(y, dropout(x, p, torch.Generator().manual_seed(2)))

    model = init_model(EESPNet(s=0.5, num_classes=CLASSES),
                       torch.Generator().manual_seed(0)).train()
    x = normalize(torch.from_numpy(_images(2, seed=36)))
    with pytest.raises(ValueError, match="generator"):
        model(x)
    with torch.no_grad():
        a = model(x, torch.Generator().manual_seed(3))
        b = model(x, torch.Generator().manual_seed(3))
        c = model(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cls_eval_step_counts_match_jax(forward_case):
    """The eval step's (correct, valid) over 5 images in batches of 4 (the
    tail batch padded with 3 invalid rows) equal the JAX package's."""
    s, variables, _, _ = forward_case
    imgs = _images(5, seed=37)
    labels = np.random.default_rng(38).integers(0, CLASSES, 5)

    class Set:
        def __len__(self):
            return 5

        def load(self, i):
            return imgs[i], np.int32(labels[i])

    jax_model = FlaxEESPNet(s=s, num_classes=CLASSES)
    jax_step = jax_cls.make_cls_eval_step(jax_model)
    want = [tuple(int(v) for v in jax_step(
        variables["params"], variables["batch_stats"],
        jax.tree_util.tree_map(jnp.asarray, b)))
        for b in JaxDataLoader(Set(), 4)]
    step = train_cls.make_cls_eval_step(_port(variables, s), device="cpu")
    got = [tuple(int(v) for v in step(b)) for b in DataLoader(Set(), 4)]
    assert got == want
    assert [v for _, v in got] == [4, 1]


def test_train_classification_learns():
    """Ten epochs of AdamW on class-colored noise images (4 classes, 32
    training and 16 validation images, batches of 8): top-1 above 0.7, as
    the JAX package's own test asks of its loop."""
    model = init_model(EESPNet(s=0.5, num_classes=4),
                       torch.Generator().manual_seed(0))
    cfg = train_cls.ClsTrainConfig(epochs=10, lr=0.005, scheduler="fixed",
                                   optimizer="adam", weight_decay=1e-5,
                                   verbose=False)
    res = train_cls.train_classification(
        model, None,
        DataLoader(ColorClassDataset(length=32, seed=1), 8, shuffle=True),
        DataLoader(ColorClassDataset(length=16, seed=2), 8), cfg,
        device="cpu")
    assert [h["epoch"] for h in res["history"]] == list(range(10))
    assert res["state"].step == 40
    assert res["best_acc"] == max(h["acc"] for h in res["history"])
    assert res["best_acc"] > 0.7, res["history"]


def test_pretrained_encoder_matches_jax(forward_case):
    """`encoder_variables_from_classifier` and `load_pretrained_encoder`
    give the JAX package's trees from the same classifier and
    segmentation trees, leaf for leaf; `copy_encoder` puts the same
    encoder into a segmentation module."""
    s, cls_vars, _, _ = forward_case
    seg_vars = perturbed_tree(FlaxESPNetv2(num_classes=3, s=s), HW, seed=39)
    want_enc = jax_cls.encoder_variables_from_classifier(cls_vars)
    got_enc = train_cls.encoder_variables_from_classifier(cls_vars)
    assert jax.tree_util.tree_structure(got_enc) == \
        jax.tree_util.tree_structure(want_enc)
    assert "level5_0" not in got_enc["params"]
    assert "classifier" not in got_enc["params"]
    want = jax.device_get(jax_cls.load_pretrained_encoder(seg_vars,
                                                          cls_vars))
    before = copy.deepcopy(seg_vars)
    got = train_cls.load_pretrained_encoder(seg_vars, cls_vars)
    assert jax.tree_util.tree_structure(seg_vars) == \
        jax.tree_util.tree_structure(before)
    for a, b in zip(jax.tree_util.tree_leaves(seg_vars),
                    jax.tree_util.tree_leaves(before)):
        assert np.array_equal(a, b)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(np.asarray(a), np.asarray(b))

    seg = ESPNetv2Segmentation(3, s=s)
    load_flax_variables(seg, seg_vars)
    copy_encoder(seg, _port(cls_vars, s))
    for a, b in zip(jax.tree_util.tree_leaves(flax_variables(seg)),
                    jax.tree_util.tree_leaves(_numpy_tree(want))):
        assert a.tobytes() == np.asarray(b, np.float32).tobytes()
