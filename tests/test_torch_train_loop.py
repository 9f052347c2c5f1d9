"""The port's train loop against the JAX package on the CPU, and the
train-side pieces a self-training round adds: `train_segmentation` (2
epochs, augmentation off, SGD on the poly schedule and AdamW at a fixed
lr) from one flax tree against the JAX package's (the history, the val
mIoU and every parameter and statistic), `max_steps`, the augmented
train step, and the bound on the branch stack's plan cache.

The bounds on parameters and statistics are those of
tests/test_torch_train.py at the step count (`_check_sgd`,
`_check_adam`), since two fp32 trajectories drift apart ~10x a step.  An
epoch is one step of a batch of 2: AdamW turns gradients at fp32 noise
into +-lr moves, and the share of elements so moved grows with the steps
(0.25% after 4 steps, beyond `_check_adam`'s 0.1%, which holds at 2)."""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from mspl_tpu.data.datasets import SyntheticSegmentation as JaxSynthetic
from mspl_tpu.data.loader import DataLoader as JaxDataLoader
from mspl_tpu.engine import train as jax_train
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu_torch.data.datasets import SyntheticSegmentation
from mspl_tpu_torch.data.loader import DataLoader
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import (TrainLoopConfig, create_train_state,
                                         make_eval_step, make_train_step,
                                         step_generator, train_segmentation)
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.ops import pyrpool
from mspl_tpu_torch.utils.flax_bridge import load_flax_variables
from tests.test_torch_model import flax_variables
from tests.test_torch_train import _check_adam, _check_sgd, _numpy_tree

HW = (32, 48)
CLASSES = 3
MODEL_KW = dict(s=0.5, dec_base_planes=8)
N_TRAIN, N_VAL, BATCH, EPOCHS = 2, 4, 2, 2
LOOPS = {"sgd": dict(optimizer="sgd", scheduler="poly", lr=0.005),
         "adam": dict(optimizer="adam", scheduler="fixed", lr=1e-4)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's CPU ops on two threads for this module: the tests run in
    several workers on one host, where small ops on as many threads as
    cores mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _loop_cfg(name, cls, **kw):
    return cls(epochs=EPOCHS, crop_hw=HW, augment=False, seed=1,
               verbose=False, reg_mode="kld", reg_weight=0.1, **kw,
               **LOOPS[name])


def _sets(synthetic):
    return (synthetic(CLASSES, (HW[1], HW[0]), N_TRAIN, seed=5),
            synthetic(CLASSES, (HW[1], HW[0]), N_VAL, seed=6))


@pytest.fixture(scope="module")
def loops():
    model = FlaxESPNetv2(num_classes=CLASSES, channel_major_logits=True,
                         **MODEL_KW)
    variables = flax_variables(model, HW, seed=21)
    out = {"variables": variables}
    for name in LOOPS:
        train, val = _sets(JaxSynthetic)
        res = jax_train.train_segmentation(
            model, variables,
            JaxDataLoader(train, BATCH, shuffle=True, seed=1),
            JaxDataLoader(val, BATCH), CLASSES,
            # the state dispatched leaf by leaf: the same math, and a
            # quarter less compile time here
            _loop_cfg(name, jax_train.TrainLoopConfig, pack_dispatch=False))
        st = jax.device_get(res["state"])
        out[name] = dict(history=res["history"], best=res["best_miou"],
                         tree=_numpy_tree({"params": st.params,
                                           "batch_stats": st.batch_stats}))
    return out


def _port_loop(variables, name, **cfg_kw):
    model = ESPNetv2Segmentation(CLASSES, **MODEL_KW)
    train, val = _sets(SyntheticSegmentation)
    cfg = _loop_cfg(name, TrainLoopConfig)
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    res = train_segmentation(model, variables,
                             DataLoader(train, BATCH, shuffle=True, seed=1),
                             DataLoader(val, BATCH), CLASSES, cfg,
                             device="cpu")
    return model, res


@pytest.mark.parametrize("name", list(LOOPS))
def test_train_segmentation_matches_jax(loops, name):
    """Two epochs of one step: each epoch's loss within 10^(i-6) relative
    at its step i, its lr equal, its val mIoU within 1e-3 (confusion
    counts of near-tied pixels may move), the best mIoU as the history's;
    then every parameter and statistic within the step bounds of
    tests/test_torch_train.py at the second step."""
    model, res = _port_loop(loops["variables"], name)
    want = loops[name]
    assert [h["epoch"] for h in res["history"]] == [0, 1]
    for got_h, want_h in zip(res["history"], want["history"]):
        last = (got_h["epoch"] + 1) * (N_TRAIN // BATCH) - 1
        np.testing.assert_allclose(got_h["loss"], want_h["loss"],
                                   rtol=10.0 ** (last - 6))
        np.testing.assert_allclose(got_h["lr"], want_h["lr"], rtol=1e-6)
        assert abs(got_h["miou"] - want_h["miou"]) <= 1e-3
    assert res["best_miou"] == max(h["miou"] for h in res["history"])
    assert abs(res["best_miou"] - want["best"]) <= 1e-3
    assert res["state"].step == EPOCHS * N_TRAIN // BATCH
    ref = copy.deepcopy(model)
    load_flax_variables(ref, want["tree"])
    check = _check_sgd if name == "sgd" else _check_adam(LOOPS[name]["lr"])
    check(res["state"].step - 1, res["history"][-1]["loss"],
          want["history"][-1]["loss"], model, ref)


def test_max_steps_stops_the_loop():
    """`max_steps` stops after that many updates, inside the first epoch:
    no epoch completes, so the history is empty and no mIoU is taken."""
    model, res = _port_loop(None, "sgd", max_steps=1)
    assert res["state"].step == 1
    assert res["history"] == [] and res["best_miou"] == -1.0


@pytest.mark.parametrize("kwargs", [dict(remat=True), dict(bn_groups=2)],
                         ids=["remat", "bn_groups"])
def test_remat_and_bn_groups_reach_the_step(monkeypatch, kwargs):
    """`TrainLoopConfig.remat` and `bn_groups` reach `make_train_step`.
    With `remat` the loop ends bit for bit where it ends without; with
    `bn_groups=2` (ghost-batch statistics over each sample of the batches
    of 2) it ends elsewhere."""
    import mspl_tpu_torch.engine.train as port_train

    seen = []

    def recording(*a, **kw):
        seen.append({k: kw[k] for k in ("remat", "bn_groups")})
        return make_train_step(*a, **kw)

    torch.manual_seed(0)
    start = ESPNetv2Segmentation(CLASSES, **MODEL_KW).state_dict()
    plain, _ = _port_loop(start, "sgd")
    monkeypatch.setattr(port_train, "make_train_step", recording)
    model, res = _port_loop(start, "sgd", **kwargs)
    assert seen == [{"remat": kwargs.get("remat", False),
                     "bn_groups": kwargs.get("bn_groups", 1)}]
    assert res["state"].step == EPOCHS * N_TRAIN // BATCH
    same = [torch.equal(v, model.state_dict()[k])
            for k, v in plain.state_dict().items()]
    assert all(same) if "remat" in kwargs else not all(same)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(resume=True), dict(ckpt_every_steps=1)],
    ids=["ckpt_dir", "resume", "ckpt_every_steps"])
def test_checkpoint_options_run(tmp_path, kwargs):
    """`ckpt_dir` (alone, with `resume` and no checkpoint yet, and with
    `ckpt_every_steps`) writes the last and the best train state after each
    epoch; the run is the one without checkpoints, bit for bit."""
    torch.manual_seed(0)
    start = ESPNetv2Segmentation(CLASSES, **MODEL_KW).state_dict()
    plain, _ = _port_loop(start, "sgd")
    model, res = _port_loop(start, "sgd", ckpt_dir=str(tmp_path), **kwargs)
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint_best.json", "checkpoint_best.msgpack",
        "checkpoint_last.json", "checkpoint_last.msgpack"]
    with open(tmp_path / "checkpoint_last.json") as f:
        assert json.load(f)["epoch"] == EPOCHS - 1
    for k, v in plain.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def _aug_step(model, seed_batch=3):
    rng = np.random.default_rng(seed_batch)
    batch = {"image": rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8),
             "label": rng.integers(0, CLASSES, (2, 40, 56)).astype(np.int32)}
    sched = build_schedule("fixed", 0.01, 4)
    state = create_train_state(model, "sgd", sched, device="cpu")
    step = make_train_step(model, augment=True, crop_hw=HW,
                           scale_range=(0.7, 1.3), device="cpu")
    return state, step, batch


def test_augmented_step_runs_and_its_crops_follow_the_step():
    """`make_train_step(augment=True)` trains on crops of `crop_hw` from a
    larger batch; the draws come from the step's own generator, so two
    copies of a model take the same step from `step_generator(seed, i)`
    whatever ran before, and another step's generator gives another
    loss."""
    torch.manual_seed(0)
    base = ESPNetv2Segmentation(CLASSES, **MODEL_KW)
    losses = []
    for warm in (0, 2):
        model = copy.deepcopy(base)
        state, step, batch = _aug_step(model)
        for i in range(warm):  # other draws before: no effect on step 5's
            torch.rand(7)
        state, m = step(state, batch, step_generator(1, 5))
        losses.append(m["loss"].item())
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    model = copy.deepcopy(base)
    state, step, batch = _aug_step(model)
    state, m = step(state, batch, step_generator(1, 6))
    assert m["loss"].item() != losses[0]
    assert state.step == 1
    with pytest.raises(ValueError, match="crop_hw"):
        make_train_step(model, augment=True, device="cpu")


def test_train_after_eval_on_one_model():
    """An eval step (inference mode) and then a train step on the same
    model and shapes, as each epoch of the loop runs them: the operators
    the eval forward caches are usable by the train step's backward."""
    model = ESPNetv2Segmentation(CLASSES, **MODEL_KW)
    train, val = _sets(SyntheticSegmentation)
    batch = next(iter(DataLoader(val, BATCH)))
    make_eval_step(model, CLASSES, device="cpu")(batch)
    state = create_train_state(model, "sgd", build_schedule("fixed", 0.01, 1),
                               device="cpu")
    _, m = make_train_step(model, augment=False, device="cpu")(state, batch)
    assert np.isfinite(m["loss"].item())


def test_plan_cache_is_bounded():
    """The branch stack's plans are kept per kind in an LRU of
    PLAN_CACHE_SIZE entries: more distinct plane shapes than that leave
    each kind at the bound, a repeated shape is a hit (the same plan
    object), and the oldest shape is the one dropped."""
    scales = (2.0, 1.5, 1.0, 0.5, 0.1)
    pyrpool._plan_cache.clear()
    shapes = [(8 + i, 12 + i) for i in range(pyrpool.PLAN_CACHE_SIZE + 5)]
    for h, w in shapes:
        pyrpool._branch_record(1, 4, h, w, scales, torch.float32, "cpu")
        pyrpool._tail_plan(h, w, scales, "cpu")
    for kind in ("down", "branch", "record", "tail"):
        assert len(pyrpool._plan_cache[kind]) == pyrpool.PLAN_CACHE_SIZE
    h, w = shapes[-1]
    assert pyrpool._tail_plan(h, w, scales, "cpu") is pyrpool._tail_plan(
        h, w, scales, "cpu")
    first = pyrpool._branch_plan(h, w, scales, "cpu")
    assert pyrpool._branch_plan(h, w, scales, "cpu") is first
    keys = list(pyrpool._plan_cache["tail"])
    assert keys[-1] == ("tail", h, w, scales, "cpu")
    assert ("tail", *shapes[0], scales, "cpu") not in keys
