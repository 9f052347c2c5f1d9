"""The train step's CUDA graphs of the model's forward and backward
(`engine/train.py`, `ops/graphs.py`), on the CPU.  A CPU step and a step
under a mesh never capture.  With a stand-in for the CUDA graph
(`tests/torch_graph_stand_in.py`), the bookkeeping: a key's
first step runs eagerly, its second captures and replays, its third
replays; another batch shape, or a batch with "valid", warms up on its
own; a parameter whose storage is replaced drops the graphs; the kernel
wrappers' launch counters count each kernel run once, also when a capture
fails; the loss and the optimizer step run eagerly every step; the replay
span lies inside the forward span; and the losses, parameters, momentum
buffers and BatchNorm statistics after the steps are the eager path's.
The card's own checks are `tests_card/test_torch_train_graph_card.py`."""

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from mspl_tpu_torch.engine import train
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import create_train_state, make_train_step
from mspl_tpu_torch.layers.conv_blocks import BatchNorm
from mspl_tpu_torch.ops import graphs
from mspl_tpu_torch.parallel.mesh import make_mesh

from tests.torch_graph_stand_in import (FailingGraph, StandInGraph, kernel,
                                        take_graph_path)

HW, CROP = (12, 16), (8, 12)
CLASSES = 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Counted(torch.autograd.Function):
    """The identity, launching the stand-in kernel once in its forward and
    once in its backward, as a kernel with a backward of its own would."""

    @staticmethod
    def forward(ctx, x):
        return kernel(x)

    @staticmethod
    def backward(ctx, g):
        return kernel(g)


class _Net(nn.Module):
    """A 3x3 convolution, the port's train BatchNorm, `_Counted` and a 1x1
    convolution to channel-major logits at the input's size."""

    def __init__(self, seed=0):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.bn = BatchNorm(4)
        self.head = nn.Conv2d(4, CLASSES, 1)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)

    def forward(self, x):
        return self.head(torch.relu(_Counted.apply(self.bn(self.conv(x)))))


@pytest.fixture
def stand_in(monkeypatch):
    """The step's graph path taken on the CPU, with the stand-in graph."""
    return take_graph_path(monkeypatch)


def _setup(seed=0, mesh=None):
    """A model, its SGD state and its train step, all on the CPU."""
    model = _Net(seed)
    state = create_train_state(model, "sgd", build_schedule("poly", 0.05, 8),
                               momentum=0.9, weight_decay=1e-3, device="cpu")
    step = make_train_step(model, crop_hw=CROP, scale_range=(0.8, 1.25),
                           class_weights=[1.0, 2.0, 0.5], reg_mode="kld",
                           reg_weight=0.1, device="cpu", mesh=mesh)
    return model, state, step


def _batch(seed, n=2, valid=None):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, CLASSES, (n, *HW))
    lab = np.where(rng.random((n, *HW)) < 0.3, 255, lab).astype(np.int32)
    out = {"image": rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8),
           "label": lab}
    if valid is not None:
        out["valid"] = np.asarray(valid)
    return out


def _run(state, step, batches):
    """The steps' losses, each step drawing from its own generator."""
    losses = []
    for i, b in enumerate(batches):
        state, m = step(state, b, torch.Generator().manual_seed(100 + i))
        losses.append(m["loss"].clone())
    return losses


def _counts(step):
    return step.eager_steps, step.graph_captures, step.graph_replays


def _result(model, state, losses):
    buffers = [state.optimizer.state[p]["momentum_buffer"].clone()
               for p in model.parameters()]
    return (losses, {k: v.clone() for k, v in model.state_dict().items()},
            buffers)


def _eager_twin(batches):
    """The same steps from the same weights with every forward eager."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "graphable", lambda x: False)
        model, state, step = _setup()
        losses = _run(state, step, batches)
    assert _counts(step) == (len(batches), 0, 0)
    return _result(model, state, losses)


def _same(got, want):
    (la, sa, ba), (lb, sb, bb) = got, want
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert all(torch.equal(a, b) for a, b in zip(ba, bb))


def test_a_cpu_step_never_captures():
    model, state, step = _setup()
    _run(state, step, [_batch(i) for i in range(3)])
    assert _counts(step) == (3, 0, 0)


def test_a_step_with_a_mesh_never_captures(stand_in):
    model, state, step = _setup(mesh=make_mesh())
    _run(state, step, [_batch(i) for i in range(3)])
    assert _counts(step) == (3, 0, 0)
    assert not StandInGraph.made


def test_first_step_eager_second_captures_third_replays(stand_in):
    model, state, step = _setup()
    seen, bn = [], []
    for i in range(5):
        _run(state, step, [_batch(i)])
        seen.append(_counts(step))
        bn.append(model.bn.running_mean.clone())
    assert seen == [(1, 0, 0), (1, 1, 1), (1, 1, 2), (1, 1, 3), (1, 1, 4)]
    # one forward and one backward graph, in one pool
    assert len(StandInGraph.made) == 2
    assert len({id(g.pool) for g in StandInGraph.made}) == 1
    # the statistics moved once a step: the capture left them as they were
    assert all(not torch.equal(a, b) for a, b in zip(bn, bn[1:]))


def test_replayed_steps_leave_the_eager_steps_state(stand_in):
    batches = [_batch(i) for i in range(5)]
    want = _eager_twin(batches)
    model, state, step = _setup()
    losses = _run(state, step, batches)
    assert _counts(step) == (1, 1, 4)
    _same(_result(model, state, losses), want)


def test_another_shape_or_valid_warms_up_on_its_own(stand_in):
    model, state, step = _setup()
    _run(state, step, [_batch(0), _batch(1)])
    assert _counts(step) == (1, 1, 1)
    _run(state, step, [_batch(2, n=3)])
    assert _counts(step) == (2, 1, 1)
    _run(state, step, [_batch(3, n=3), _batch(4, valid=[True, False])])
    assert _counts(step) == (3, 2, 2)
    _run(state, step, [_batch(5, valid=[True, True]), _batch(6)])
    assert _counts(step) == (3, 3, 4)
    assert len(StandInGraph.made) == 6


def test_a_replaced_storage_drops_the_graphs(stand_in):
    batches = [_batch(i) for i in range(6)]
    model, state, step = _setup()
    _run(state, step, batches[:3])
    assert _counts(step) == (1, 1, 2)
    w = model.conv.weight
    w.data = w.data.clone()
    _run(state, step, batches[3:5])
    # the next step ran eagerly, the one after captured again
    assert _counts(step) == (2, 2, 3)
    _run(state, step, batches[5:])
    assert _counts(step) == (2, 2, 4)
    assert len(StandInGraph.made) == 4


def test_launch_counters_count_each_kernel_run_once(stand_in):
    model, state, step = _setup()
    _run(state, step, [_batch(i) for i in range(4)])
    assert _counts(step) == (1, 1, 3)
    # the stand-in kernel runs once in the forward and once in the
    # backward of each step
    assert stand_in.launches == 4 * 2


def test_a_failed_capture_undoes_its_counts(stand_in, monkeypatch):
    model, state, step = _setup()
    _run(state, step, [_batch(0)])
    monkeypatch.setattr(graphs, "CudaGraph", FailingGraph)
    with pytest.raises(RuntimeError, match="capture failed"):
        _run(state, step, [_batch(1)])
    # the eager step's forward and backward, none of the capture's
    assert stand_in.launches == 2
    # the model's own forward is back
    assert "forward" not in vars(model)


def test_the_loss_and_the_optimizer_run_eagerly_every_step(stand_in,
                                                          monkeypatch):
    calls = {"loss": 0, "opt": 0}
    real = train.segmentation_loss

    def loss(*a, **k):
        calls["loss"] += 1
        return real(*a, **k)

    monkeypatch.setattr(train, "segmentation_loss", loss)
    model, state, step = _setup()

    def after(opt, args, kwargs):
        calls["opt"] += 1

    handle = state.optimizer.register_step_post_hook(after)
    try:
        _run(state, step, [_batch(i) for i in range(4)])
    finally:
        handle.remove()
    assert _counts(step) == (1, 1, 3)
    assert calls == {"loss": 4, "opt": 4}


def test_a_hook_on_the_model_brackets_the_replay(stand_in):
    model, state, step = _setup()
    _run(state, step, [_batch(0), _batch(1)])
    order = []
    hooks = [model.register_forward_pre_hook(lambda m, a: order.append("pre")),
             model.register_forward_hook(
                 lambda m, a, o: order.append(("post", o.shape)))]
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _run(state, step, [_batch(2)])
    finally:
        for h in hooks:
            h.remove()
    assert _counts(step) == (1, 1, 2)
    assert order == ["pre", ("post", (2, CLASSES, *CROP))]
    spans = {e.name: e.time_range for e in prof.events()
             if e.name.startswith("mspl.train.")}
    fwd, rep = spans["mspl.train.forward"], spans["mspl.train.replay"]
    assert fwd.start <= rep.start and rep.end <= fwd.end


def test_a_remat_step_never_captures(stand_in):
    model = _Net()
    state = create_train_state(model, "sgd", build_schedule("poly", 0.05, 8),
                               device="cpu")
    step = make_train_step(model, crop_hw=CROP, remat=True, device="cpu")
    _run(state, step, [_batch(i) for i in range(3)])
    assert _counts(step) == (3, 0, 0)
    assert not StandInGraph.made
