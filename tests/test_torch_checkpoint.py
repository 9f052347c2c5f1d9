"""Checkpoints that both packages read, on the CPU: the port's msgpack
codec against `msgpack` and `flax.serialization`; model checkpoints of
ESPNetv2 and DeepLab written by each package and read by the other, leaf
for leaf and bit for bit (and a JAX-written file read and rewritten by the
port, byte for byte); SGD and AdamW train states after 2 steps, written by
one package and resumed by the other for a third step, against the writer
taking the same step; the port's mid-epoch resume against its
uninterrupted run; and a self-training run's round checkpoints."""

import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from mspl_tpu.engine.schedules import build_schedule as jax_schedule
from mspl_tpu.engine.train import build_optimizer as jax_optimizer
from mspl_tpu.engine.train import create_train_state as jax_state
from mspl_tpu.engine.train import make_train_step as jax_train_step
from mspl_tpu.models import DeepLabV3 as FlaxDeepLab
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu.utils import checkpoint as jax_ckpt
from mspl_tpu_torch.cli import load_model_checkpoint
from mspl_tpu_torch.data.datasets import SyntheticSegmentation
from mspl_tpu_torch.data.loader import DataLoader
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import (TrainLoopConfig, create_train_state,
                                         make_train_step,
                                         restore_train_state,
                                         train_segmentation, train_state_tree)
from mspl_tpu_torch.models import (DeepLabV3, ESPNetv2Segmentation,
                                   init_model)
from mspl_tpu_torch.pseudo.generate import make_source
from mspl_tpu_torch.pseudo.self_training import SelfTrainConfig, self_training
from mspl_tpu_torch.utils import _msgpack
from mspl_tpu_torch.utils import checkpoint as port_ckpt
from mspl_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables)
from tests.test_torch_model import flax_variables as perturbed_tree
from tests.test_torch_train import (ADAM_SCHEDULE, CLASSES, HW, MODEL_KW,
                                    SGD_SCHEDULE, _batches, _check_adam,
                                    _check_sgd, _f64_twin, _flax_layout,
                                    _numpy_tree, _two_threads)  # noqa: F401

DL_KW = dict(stage_blocks=(1, 1, 1, 1), aspp_features=32)
MODELS = {
    "espnetv2": (lambda: FlaxESPNetv2(num_classes=CLASSES,
                                      channel_major_logits=True, **MODEL_KW),
                 lambda: ESPNetv2Segmentation(CLASSES, **MODEL_KW),
                 dict(s=0.5, dec_base_planes=8)),
    "deeplabv3": (lambda: FlaxDeepLab(num_classes=CLASSES, **DL_KW),
                  lambda: DeepLabV3(CLASSES, **DL_KW),
                  dict(stage_blocks=[1, 1, 1, 1], aspp_features=32)),
}
SCHEDULES = {"sgd": SGD_SCHEDULE, "adam": ADAM_SCHEDULE}


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _assert_same_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


# --------------------------------------------------------------- the codec

def _codec_trees():
    rng = np.random.default_rng(0)
    return {
        "scalars": {"step": 0, "neg": -40, "u16": 70000, "i64": -2 ** 40,
                    "f": 0.25, "t": True, "n": None, "s": "x" * 40,
                    "np_i32": np.int32(7), "np_f32": np.float32(1.5)},
        "arrays": {"f32": rng.standard_normal((3, 4)).astype(np.float32),
                   "i32": np.arange(5, dtype=np.int32),
                   "zero_d": np.asarray(3, np.int32),
                   "u8": rng.integers(0, 256, (70, 70), dtype=np.uint8),
                   "empty": np.zeros((0, 2), np.float32)},
        "nested": {"opt_state": {"0": {}, "1": {str(i): {"count": np.asarray(
            i, np.int32)} for i in range(20)}},
            "params": {"a": {"kernel": np.ones((3, 3, 1, 8), np.float32)}}},
    }


@pytest.mark.parametrize("name", list(_codec_trees()))
def test_codec_matches_flax_both_ways(name):
    """flax's bytes (`to_bytes`, the checkpoints' writer: map keys in
    insertion order) decode to the same tree and re-encode to the same
    bytes; the port's bytes decode through msgpack and flax alike."""
    tree = _codec_trees()[name]
    flax_bytes = serialization.to_bytes(tree)
    mine = _msgpack.packb(tree)
    assert mine == flax_bytes
    back = _msgpack.unpackb(flax_bytes)
    assert _msgpack.packb(back) == flax_bytes
    want = serialization.msgpack_restore(mine)
    for k, v in _leaves(want).items():
        got = _leaves(back)[k]
        assert type(got) is type(v) and np.array_equal(got, v), k
    raw = msgpack.unpackb(mine, raw=False, strict_map_key=False)
    assert list(raw) == list(tree)


def test_codec_bf16_and_refusals():
    """A bfloat16 leaf reads as a torch bf16 tensor and writes back as
    flax wrote it; the chunked-array marker and unknown ext types raise."""
    flax_bytes = serialization.to_bytes(
        {"w": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3))})
    got = _msgpack.unpackb(flax_bytes)["w"]
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3)
    assert torch.equal(got.float(), torch.arange(6.0).reshape(2, 3))
    assert _msgpack.packb({"w": got}) == flax_bytes
    chunked = msgpack.packb({"x": {"__msgpack_chunked_array__": True}})
    with pytest.raises(ValueError, match="chunked"):
        _msgpack.unpackb(chunked)
    with pytest.raises(ValueError, match="ext type 9"):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(9, b"ab")))


# ------------------------------------------------------ model checkpoints

def _meta(name):
    return {"dataset": "greenhouse", "model": name, "s": 0.5,
            "num_classes": CLASSES, "bf16": False, "input_hw": list(HW),
            "in_channels": 3, **MODELS[name][2]}


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_model_checkpoint_reads_into_the_port(tmp_path, name):
    """The JAX package's `save_checkpoint` of a model tree: the port reads
    it leaf for leaf, loads it (the CLI's `load_model_checkpoint`) and
    exports the same tree, and rewrites the very bytes."""
    tree = perturbed_tree(MODELS[name][0](), HW, seed=3)
    jax_ckpt.save_checkpoint(str(tmp_path), tree, _meta(name),
                             name="model_best")
    path = tmp_path / "model_best.msgpack"
    got, meta = port_ckpt.load_checkpoint(str(path))
    assert meta == _meta(name)
    _assert_same_leaves(got, tree)
    model, variables, _ = load_model_checkpoint(str(tmp_path))
    _assert_same_leaves(flax_variables(model), tree)
    port_ckpt.save_checkpoint(str(tmp_path / "again"), got, meta,
                              name="model_best")
    assert (tmp_path / "again" / "model_best.msgpack").read_bytes() == \
        path.read_bytes()


@pytest.mark.parametrize("name", list(MODELS))
def test_port_model_checkpoint_reads_into_jax(tmp_path, name):
    """The port's checkpoint of a model restores into the JAX package's
    variable structure, bit for bit."""
    model = init_model(MODELS[name][1](), torch.Generator().manual_seed(4))
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.add_(torch.rand(t.shape,
                                  generator=torch.Generator().manual_seed(5)))
    tree = flax_variables(model)
    port_ckpt.save_checkpoint(str(tmp_path), tree, _meta(name),
                              name="model_best")
    target = jax.eval_shape(lambda: MODELS[name][0]().init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, *HW, 3), jnp.float32), train=False))
    target = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    target)
    got, _ = jax_ckpt.load_checkpoint(
        str(tmp_path / "model_best.msgpack"), target)
    _assert_same_leaves(_numpy_tree(got), tree)


# ---------------------------------------------------------- train states

def _port_state(variables, optimizer):
    sched = SCHEDULES[optimizer]
    port = ESPNetv2Segmentation(CLASSES, **MODEL_KW)
    load_flax_variables(port, variables)
    state = create_train_state(port, optimizer, build_schedule(
        sched["name"], sched["base_lr"], sched["total_steps"],
        **{k: v for k, v in sched.items()
           if k not in ("name", "base_lr", "total_steps")}), device="cpu")
    return state, make_train_step(port, class_weights=None, augment=False,
                                  device="cpu")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per optimizer: the JAX state after 2 steps (as a checkpoint file),
    its third step (loss, tree), and the JAX step and a fresh state to
    resume a port checkpoint into."""
    model = MODELS["espnetv2"][0]()
    variables = perturbed_tree(model, HW, seed=11)
    batches = _batches(3)
    step = jax_train_step(model, augment=False, donate=False)
    out = {"variables": variables, "batches": batches}
    for opt, sched in SCHEDULES.items():
        tx = jax_optimizer(opt, jax_schedule(
            sched["name"], sched["base_lr"], sched["total_steps"],
            **{k: v for k, v in sched.items()
               if k not in ("name", "base_lr", "total_steps")}))
        # the step count as an int32 array from the start, as the loaded
        # states hold it: one compiled step serves them all
        fresh = jax_state(model, variables, tx).replace(
            step=jnp.asarray(0, jnp.int32))
        state = fresh
        for i in range(2):
            state, _ = step(state, jax.tree_util.tree_map(
                jnp.asarray, batches[i]), jax.random.PRNGKey(i))
        ck = tmp_path_factory.mktemp(f"jax_{opt}")
        jax_ckpt.save_checkpoint(str(ck), state, {"epoch": 0})
        state3, m = step(state, jax.tree_util.tree_map(
            jnp.asarray, batches[2]), jax.random.PRNGKey(2))
        out[opt] = dict(ckpt=str(ck), fresh=fresh, step=step,
                        loss3=float(m["loss"]), tree3=_numpy_tree(
                            {"params": state3.params,
                             "batch_stats": state3.batch_stats}))
    return out


def _check(optimizer, share=1e-3):
    return (_check_sgd if optimizer == "sgd"
            else _check_adam(ADAM_SCHEDULE["base_lr"], share))


# AdamW elements allowed beyond `_check_adam`'s 1e-6 + 1e-5 relative in the
# third step of a resumed state, each fp32 step against the port's f64 step
# (`_f64_twin`): the port's 0.1% as everywhere (measured none of 73,103 at
# 1, 2, 4 and 8 threads, every element within 1.2e-7); JAX's 1% (measured
# 367 at 4 and 8 threads, 0.5%, within 1.38e-5, and none at 1 and 2: the
# state the port writes decides which gradients sit at fp32 noise, where
# Adam moves by up to lr whatever their sign), about twice; the two fp32
# steps within the sum (measured by `python -m tests.torch_rounding_gaps`)
ADAM_SHARE_PORT, ADAM_SHARE_JAX = 1e-3, 1e-2


@pytest.mark.parametrize("optimizer", list(SCHEDULES))
def test_port_resumes_a_jax_train_state(jax_runs, optimizer):
    """JAX takes 2 steps and writes its TrainState; the port restores it
    (parameters, statistics, momentum trace or Adam moments, counts) and
    takes the third step, which matches JAX's third step within the one-
    step bounds of tests/test_torch_train.py."""
    run = jax_runs[optimizer]
    state, step = _port_state(jax_runs["variables"], optimizer)
    tree, _ = port_ckpt.load_checkpoint(run["ckpt"])
    restore_train_state(state, tree)
    assert state.step == 2
    state, m = step(state, jax_runs["batches"][2])
    _check(optimizer)(0, m["loss"].item(), run["loss3"], state.model,
                      _flax_layout(run["tree3"], state.model))


@pytest.mark.usefixtures("_two_threads")
@pytest.mark.parametrize("optimizer", list(SCHEDULES))
def test_jax_resumes_a_port_train_state(tmp_path, jax_runs, optimizer):
    """The port takes 2 steps and writes `train_state_tree`; the JAX
    package restores it into its own TrainState and takes the third step,
    which matches the port's third step.  Both are held against the port's
    third step in f64 from the same state, within the one-step bounds of
    tests/test_torch_train.py (AdamW: `ADAM_SHARE_PORT`,
    `ADAM_SHARE_JAX`), and against each other within their sum."""
    run = jax_runs[optimizer]
    state, step = _port_state(jax_runs["variables"], optimizer)
    for i in range(2):
        state, _ = step(state, jax_runs["batches"][i])
    port_ckpt.save_checkpoint(str(tmp_path), train_state_tree(state))
    jstate, _ = jax_ckpt.load_checkpoint(str(tmp_path), run["fresh"])
    assert int(jstate.step) == 2
    jstate, m = run["step"](jstate, jax.tree_util.tree_map(
        jnp.asarray, jax_runs["batches"][2]), jax.random.PRNGKey(2))
    wide, wide_step = _f64_twin(state, optimizer)
    wide, wm = wide_step(wide, jax_runs["batches"][2])
    state, pm = step(state, jax_runs["batches"][2])
    ref = _flax_layout(_numpy_tree({"params": jstate.params,
                                    "batch_stats": jstate.batch_stats}),
                       state.model)
    _check(optimizer, ADAM_SHARE_PORT)(0, pm["loss"].item(), wm["loss"].item(),
                                       state.model, wide.model)
    _check(optimizer, ADAM_SHARE_JAX)(0, float(m["loss"]), wm["loss"].item(),
                                      ref, wide.model)
    _check(optimizer, ADAM_SHARE_PORT + ADAM_SHARE_JAX)(
        0, pm["loss"].item(), float(m["loss"]), state.model, ref)


@pytest.mark.parametrize("optimizer", list(SCHEDULES))
def test_train_state_tree_round_trip(optimizer):
    """A port state written and restored into a fresh state is the same
    state: parameters, statistics, buffers and step, bit for bit."""
    tree = perturbed_tree(MODELS["espnetv2"][0](), HW, seed=12)
    a, step = _port_state(tree, optimizer)
    for b in _batches(2):
        a, _ = step(a, b)
    b, _ = _port_state(tree, optimizer)
    restore_train_state(b, _msgpack.unpackb(_msgpack.packb(
        train_state_tree(a))))
    assert b.step == a.step == 2
    for k, v in a.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, b.model.state_dict()[k]), k
    pa = dict(a.model.named_parameters())
    pb = dict(b.model.named_parameters())
    for k, p in pa.items():
        for buf, t in a.optimizer.state[p].items():
            assert torch.equal(t, b.optimizer.state[pb[k]][buf]), (k, buf)


# --------------------------------------------------------------- resume

@pytest.mark.usefixtures("_two_threads")
@pytest.mark.parametrize("optimizer", list(SCHEDULES))
def test_mid_epoch_resume_is_bit_equal(tmp_path, optimizer):
    """`ckpt_every_steps=1` with a run stopped after 3 of its 4 steps an
    epoch (`max_steps`), then `resume=True` to the end of its 2 epochs: the
    model is the uninterrupted run's, bit for bit (augmented steps, each
    from its own generator)."""
    sched = SCHEDULES[optimizer]
    tree = perturbed_tree(MODELS["espnetv2"][0](), HW, seed=13)
    train = SyntheticSegmentation(CLASSES, (HW[1] + 8, HW[0] + 8), 8, seed=3)
    val = SyntheticSegmentation(CLASSES, (HW[1] + 8, HW[0] + 8), 2, seed=4)

    def run(ckpt_dir, **kw):
        model = ESPNetv2Segmentation(CLASSES, **MODEL_KW)
        cfg = TrainLoopConfig(epochs=2, crop_hw=HW, lr=sched["base_lr"],
                              scheduler="poly", optimizer=optimizer, seed=2,
                              verbose=False, ckpt_dir=ckpt_dir, **kw)
        res = train_segmentation(
            model, tree if not kw.get("resume") else None,
            DataLoader(train, 2, shuffle=True, seed=1), DataLoader(val, 2),
            CLASSES, cfg, device="cpu")
        return model, res

    whole, res_whole = run(None)
    ck = str(tmp_path)
    _, cut = run(ck, ckpt_every_steps=1, max_steps=3)
    assert cut["state"].step == 3
    with open(os.path.join(ck, "checkpoint_last.json")) as f:
        assert json.load(f) == {"epoch": 0, "step_in_epoch": 3,
                                "best_miou": -1.0}
    resumed, res = run(ck, ckpt_every_steps=1, resume=True)
    assert res["state"].step == res_whole["state"].step == 8
    assert [h["epoch"] for h in res["history"]] == [0, 1]
    assert res["history"][1]["miou"] == res_whole["history"][1]["miou"]
    for k, v in whole.state_dict().items():
        assert torch.equal(v, resumed.state_dict()[k]), k


@pytest.mark.usefixtures("_two_threads")
def test_self_training_writes_round_checkpoints(tmp_path):
    """`self_training(ckpt_dir=...)` fine-tunes round r with its train
    state checkpointed in `<ckpt_dir>/round{r}`, which the JAX package's
    TrainState layout describes (the step count of a round's fine-tune)."""
    g = torch.Generator().manual_seed(0)
    sources = [make_source(
        name, init_model(ESPNetv2Segmentation(c, **MODEL_KW), g), None,
        name, device="cpu") for name, c in (("camvid", 11), ("forest", 5))]
    target = SyntheticSegmentation(3, (HW[1], HW[0]), 4, seed=1,
                                   unlabeled=True)
    model = init_model(ESPNetv2Segmentation(3, **MODEL_KW), g)
    cfg = SelfTrainConfig(rounds=2, batch_size=2, epochs_per_round=1,
                          crop_hw=HW, verbose=False, ckpt_dir=str(tmp_path))
    self_training(model, None, sources, target, None, 3, cfg, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["round0", "round1"]
    for r in range(2):
        tree, meta = port_ckpt.load_checkpoint(str(tmp_path / f"round{r}"))
        assert meta["epoch"] == 0
        assert int(np.asarray(tree["step"])) == 2
        assert set(tree) == {"step", "params", "opt_state", "batch_stats"}
        assert int(tree["opt_state"]["1"]["1"]["count"]) == 2
