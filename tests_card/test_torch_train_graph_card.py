"""The train step's CUDA graphs of the model's forward and backward on the
card, at the fine-tune cells' configurations and shapes: f32
ESPNetv2-s2.0 (③ and its plain backward), DeepLabV3-ResNet-50 and
SegFormer-B5, batch 8 crops of 256x480 at scales 0.7-1.3, SGD with
momentum, weight decay and the KLD term, TF32 off and cuDNN's
deterministic algorithms.  From one state and the same batches, four
steps with the graphs (the first eager, the second captured, all but the
first replayed) against four eager steps: the losses, the first momentum
buffers and the parameters after the steps within the cell's limits
(`h100_bench/limits/<cell>.json`), and the BatchNorm running statistics
within its gradient limit; each kernel launched as often as the eager
steps launch it, ③ 4 times a step.  The ESPNetv2 step also at
`bn_groups=2`."""

import pytest
import torch

from h100_bench import common, program
from h100_bench.drivers.finetune import (gaps, label_histogram, leaf_gaps,
                                         make_pool, target_state)
from mspl_tpu_torch.engine.losses import compute_class_weights
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import (create_train_state, make_train_step,
                                         step_generator)
from mspl_tpu_torch.ops import graphs

CELLS = ("espnetv2_s2.finetune_b8", "deeplabv3_r50.finetune_b8",
         "segformer_b5.finetune_b8")
STEPS = 4
SEED = 2 ** 31 + 23


@pytest.fixture(autouse=True)
def _deterministic_f32():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _steps(cell, card, replayed: bool, bn_groups: int = 1):
    """STEPS train steps of the cell's model from the seed's weights on
    the seed's batches: {"losses", "buffers" (after the first step),
    "params", "init", "stats" (BatchNorm running statistics), "counts",
    "launches" (each kernel's, over the steps)}."""
    tr, cfg = cell.traffic, cell.config
    classes = cfg["target"]["classes"]
    pool = dict(tr, pool_images=STEPS * tr["batch"])
    images, labels = make_pool(SEED, pool, tuple(cfg["image_hw"]), card)
    model = program.model(cfg["model"], classes, torch.float32, card)
    model.load_state_dict(target_state(cell, SEED, card))
    state = create_train_state(
        model, "sgd", build_schedule("poly", tr["lr"], 64 * STEPS),
        tr["momentum"], tr["weight_decay"], device=card)
    step = make_train_step(
        model, crop_hw=tuple(tr["crop_hw"]),
        scale_range=tuple(tr["scale_range"]),
        class_weights=compute_class_weights(label_histogram(labels,
                                                            classes)),
        reg_mode="kld", reg_weight=tr["reg_weight"], bn_groups=bn_groups,
        device=card)
    counters = program.launch_counters(cell.launches)
    for fn in counters.values():
        fn.launches = 0
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, buffers = [], {}
    with pytest.MonkeyPatch.context() as mp:
        if not replayed:
            mp.setattr(graphs, "graphable", lambda x: False)
        for i in range(STEPS):
            rows = slice(i * tr["batch"], (i + 1) * tr["batch"])
            state, m = step(state, {"image": images[rows],
                                    "label": labels[rows]},
                            step_generator(SEED, i))
            losses.append(m["loss"].item())
            if i == 0:
                buffers = {n: state.optimizer.state[p][
                    "momentum_buffer"].clone()
                    for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    out = {"losses": losses, "buffers": buffers, "init": init,
           "params": {n: p.detach().clone()
                      for n, p in model.named_parameters()},
           "stats": {n: b.clone() for n, b in model.named_buffers()
                     if n.endswith(("running_mean", "running_var"))},
           "counts": (step.eager_steps, step.graph_captures,
                      step.graph_replays),
           "launches": {k: fn.launches for k, fn in counters.items()}}
    del state, step, model
    torch.cuda.empty_cache()
    return out


def _identical(a, b) -> bool:
    return a["losses"] == b["losses"] and all(
        torch.equal(a[k][n], b[k][n]) for k in ("buffers", "params", "stats")
        for n in b[k])


def _check(cell, got, want):
    """The replayed steps against the eager ones at the cell's limits."""
    values = gaps(got, want)
    stats = list(want["stats"])
    values["stats_gap"] = max(leaf_gaps(got["stats"], want["stats"], stats)
                              or [0.0])
    limits = {k: v for k, v in cell.limits.items() if k in values}
    limits["stats_gap"] = cell.limits["grad_gap"]
    print(f"{cell.name}: replayed against eager {values} (limits {limits}), "
          f"bit-identical {_identical(got, want)}, counts {got['counts']}, "
          f"launches {got['launches']}", flush=True)
    assert all(values[k] <= lim for k, lim in limits.items()), values
    assert got["counts"] == (1, 1, STEPS - 1)
    assert want["counts"] == (STEPS, 0, 0)
    assert got["launches"] == want["launches"] == {
        k: per * STEPS for k, per in cell.launches.items()}


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_replayed_steps_match_eager_steps(card, name):
    cell = common.load_cell(name)
    want = _steps(cell, card, replayed=False)
    got = _steps(cell, card, replayed=True)
    _check(cell, got, want)


@pytest.mark.card
def test_replayed_ghost_batch_steps_match_eager_steps(card):
    cell = common.load_cell("espnetv2_s2.finetune_b8")
    want = _steps(cell, card, replayed=False, bn_groups=2)
    got = _steps(cell, card, replayed=True, bn_groups=2)
    _check(cell, got, want)
