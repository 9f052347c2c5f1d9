"""The generator's CUDA graphs of the sources' forwards
(`pseudo/generate.py`, `ops/graphs.py`), on the CPU.  A CPU generator never
captures.  With a stand-in for the CUDA graph
(`tests/torch_graph_stand_in.py`), the bookkeeping: a key's first two batches
run eagerly and the second captures right after, the kernel wrappers'
launch counters count each kernel run once (what a capture counted is put
back, and each replay adds it), `set_variables` drops that source's graphs
alone, the pool's captures keep the sources' order, a capture finds the
plan caches warm whatever ran before its batch, and a graph keeps the
cached plans alive.  The card's own checks are `tests_card/`."""

import numpy as np
import pytest
import torch

from mspl_tpu_torch.data.loader import DataLoader
from mspl_tpu_torch.data.transforms import normalize
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.ops import graphs, pyrpool, resize_x2
from mspl_tpu_torch.ops.pseudo_cm import fused_pseudo_cm
from mspl_tpu_torch.pseudo.generate import (PseudoLabelGenerator,
                                            SourceModel, make_source)

from tests.torch_graph_stand_in import (FailingGraph, StandInGraph, kernel,
                                        take_graph_path)

HW = (8, 12)
T = 3  # target classes
CLASSES = (4, 6, 5)
LAUNCHES = (2, 3, 1)  # the stand-in kernel's launches a forward, by source


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _plan(h):
    """A cached device table as ③ looks one up: on a miss it is made on
    the host and copied to the device, which a CUDA capture refuses."""
    key = ("stand_in", h)
    hit = pyrpool._cached("stand_in", key)
    if hit is None:
        if StandInGraph.capturing:
            raise RuntimeError("host-to-device copy while capturing")
        hit = pyrpool._keep("stand_in", key, (torch.arange(h),))
    return hit


class _Head(torch.nn.Module):
    """A 1x1 convolution to C logits that launches the stand-in kernel
    `launches` times a forward and looks up cached device tables."""

    def __init__(self, classes, launches, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.conv = torch.nn.Conv2d(3, classes, 1)
        with torch.no_grad():
            self.conv.weight.copy_(torch.randn(self.conv.weight.shape,
                                               generator=g))
            self.conv.bias.copy_(torch.randn(classes, generator=g))
        self.launches = launches

    def forward(self, x):
        _plan(x.shape[2])
        resize_x2.device_taps(x.shape[2], 2 * x.shape[2], x.device)
        for _ in range(self.launches):
            x = kernel(x)
        return self.conv(x)


def _conversion(classes, seed):
    rng = np.random.default_rng(seed)
    m = rng.random((classes, T + 1)).astype(np.float32)
    return m / m.sum(1, keepdims=True)


def _sources():
    return [SourceModel(f"s{i}", _Head(c, n, i).eval(), _conversion(c, i),
                        channel_major=True)
            for i, (c, n) in enumerate(zip(CLASSES, LAUNCHES))]


@pytest.fixture
def stand_in(monkeypatch):
    """The generator's graph path taken on the CPU, with the stand-in
    graph, and empty plan caches of its own."""
    monkeypatch.setattr(pyrpool, "_plan_cache", {})
    monkeypatch.setattr(resize_x2, "_taps_cache", {})
    return take_graph_path(monkeypatch)


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, *HW, 3),
                                         dtype=np.uint8))


def _eager(sources, imgs_u8):
    """The pass as the sources compute it, every forward eager."""
    x = normalize(imgs_u8)
    with torch.inference_mode():
        lab, conf = fused_pseudo_cm([s(x) for s in sources],
                                    [s.conversion for s in sources], None)
    return lab.to(torch.uint8), conf


def _key(n=4):
    return ((n, 3, *HW), torch.float32, torch.device("cpu"))


def test_second_batch_captures_and_counters_count_kernel_runs(stand_in):
    sources = _sources()
    gen = PseudoLabelGenerator(sources, device="cpu")
    per_batch = sum(LAUNCHES)
    seen = []
    for b in range(4):
        imgs = _batch(b)
        lab, conf = gen.batch_pass(imgs)
        want_lab, want_conf = _eager(sources, imgs)
        # the stand-in counted nothing extra while the check ran eagerly
        stand_in.launches -= per_batch
        assert torch.equal(lab, want_lab)
        assert torch.equal(conf, want_conf)
        seen.append((gen.eager_forwards, gen.graph_captures,
                     gen.graph_replays, stand_in.launches))
    n = len(sources)
    assert seen == [(n, 0, 0, per_batch), (2 * n, n, 0, 2 * per_batch),
                    (2 * n, n, n, 3 * per_batch),
                    (2 * n, n, 2 * n, 4 * per_batch)]
    # one pool for every graph; the logits are each graph's own output
    replays = gen._graphs[_key()]
    assert sorted(replays) == [0, 1, 2]
    assert len({id(r.graph.pool) for r in replays.values()}) == 1
    assert [r.launches[0][1] for r in replays.values()] == list(LAUNCHES)
    assert all(r.launches[0][0] is kernel for r in replays.values())


def test_all_sources_read_one_static_input(stand_in):
    gen = PseudoLabelGenerator(_sources(), device="cpu")
    copies = []
    orig = torch.Tensor.copy_

    def copy_(self, src, *a, **k):
        if self is gen._inputs.get(_key()):
            copies.append(1)
        return orig(self, src, *a, **k)

    for b in range(2):
        gen.batch_pass(_batch(b))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "copy_", copy_)
        gen.batch_pass(_batch(2))
    assert len(copies) == 1
    assert len(gen._inputs) == 1


def test_another_shape_warms_up_on_its_own(stand_in):
    gen = PseudoLabelGenerator(_sources(), device="cpu")
    for b in range(2):
        gen.batch_pass(_batch(b))
    assert (gen.eager_forwards, gen.graph_captures) == (6, 3)
    lab, conf = gen.batch_pass(_batch(9, n=2))
    assert (gen.eager_forwards, gen.graph_captures) == (9, 3)
    assert torch.equal(conf, _eager(gen.sources, _batch(9, n=2))[1])
    gen.batch_pass(_batch(10, n=2))
    assert (gen.eager_forwards, gen.graph_captures) == (12, 6)
    gen.batch_pass(_batch(11, n=2))
    assert (gen.eager_forwards, gen.graph_replays) == (12, 3)
    assert set(gen._graphs) == {_key(), _key(2)}


def test_set_variables_drops_only_that_sources_graphs(stand_in):
    sources = _sources()
    gen = PseudoLabelGenerator(sources, device="cpu")
    for b in range(3):
        gen.batch_pass(_batch(b))
    replays = gen._graphs[_key()]
    kept = {i: replays[i] for i in (0, 2)}
    new = _Head(CLASSES[1], LAUNCHES[1], seed=11).state_dict()
    gen.set_variables(1, new)
    assert sorted(replays) == [0, 2]
    assert all(replays[i] is kept[i] for i in (0, 2))
    before = (gen.eager_forwards, gen.graph_captures, gen.graph_replays)
    gen.batch_pass(_batch(3))  # source 1 runs eagerly, the others replay
    assert (gen.eager_forwards, gen.graph_captures, gen.graph_replays) == (
        before[0] + 1, before[1], before[2] + 2)
    gen.batch_pass(_batch(4))
    # source 1 runs eagerly and captures again; source 2's graph, captured
    # before it, goes, and source 2 runs eagerly and captures after it, so
    # the pool's captures keep the sources' order
    assert (gen.eager_forwards, gen.graph_captures, gen.graph_replays) == (
        before[0] + 3, before[1] + 2, before[2] + 3)
    assert replays[0] is kept[0] and replays[2] is not kept[2]
    imgs = _batch(5)
    lab, conf = gen.batch_pass(imgs)
    assert gen.graph_replays == before[2] + 6
    # the new weights' output, replayed
    ref = _sources()
    ref[1].model.load_state_dict(new)
    stand_in.launches = 0
    want_lab, want_conf = _eager(ref, imgs)
    assert torch.equal(lab, want_lab) and torch.equal(conf, want_conf)


def test_capture_undoes_its_counts_even_when_it_fails(stand_in,
                                                      monkeypatch):
    sources = _sources()
    gen = PseudoLabelGenerator(sources, device="cpu")
    gen.batch_pass(_batch(0))
    monkeypatch.setattr(graphs, "CudaGraph", FailingGraph)
    with pytest.raises(RuntimeError, match="capture failed"):
        gen.batch_pass(_batch(1))
    # both batches' eager forwards of source 0, none of the capture's
    assert stand_in.launches == sum(LAUNCHES) + LAUNCHES[0]


def test_a_graph_keeps_the_cached_plans(stand_in):
    gen = PseudoLabelGenerator(_sources(), device="cpu")
    for b in range(2):
        gen.batch_pass(_batch(b))
    plan = _plan(HW[0])
    taps = resize_x2.device_taps(HW[0], 2 * HW[0], torch.device("cpu"))
    pyrpool._plan_cache.clear()
    resize_x2._taps_cache.clear()
    for i, rep in gen._graphs[_key()].items():
        params, buffers, plans, all_taps = rep.keep
        assert any(p is plan for p in plans)
        assert any(t is taps for t in all_taps)
        model = gen.sources[i].model
        assert params == tuple(model.parameters())
        assert buffers == tuple(model.buffers())


class _Images:
    """Seeded uint8 images for the port's `DataLoader`."""

    def __init__(self, n, hw, seed=4):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
        self.labels = np.zeros((n, *hw), np.int32)

    def __len__(self):
        return len(self.images)

    def load(self, i):
        return self.images[i], self.labels[i]


def test_a_cpu_generator_never_captures():
    hw = (32, 48)
    torch.manual_seed(0)
    sources = [make_source(name, ESPNetv2Segmentation(c, s=0.5).eval(),
                           None, name, channel_major=True, device="cpu")
               for name, c in (("camvid", 11), ("cityscapes", 19),
                               ("forest", 5))]
    gen = PseudoLabelGenerator(sources, device="cpu")
    data = _Images(6, hw)
    labels, confs, idx = gen(DataLoader(data, batch_size=4))
    assert gen.graph_captures == gen.graph_replays == 0
    assert gen.eager_forwards == 3 * 2
    assert not gen._graphs and not gen._inputs
    lab, conf = [], []
    for lo in (0, 4):
        imgs = np.zeros((4, *hw, 3), np.uint8)
        part = data.images[lo:lo + 4]
        imgs[:len(part)] = part
        out = _eager(sources, torch.from_numpy(imgs))
        lab.append(out[0][:len(part)].numpy().astype(np.int32))
        conf.append(out[1][:len(part)].numpy())
    np.testing.assert_array_equal(labels, np.concatenate(lab))
    np.testing.assert_array_equal(confs, np.concatenate(conf))
    np.testing.assert_array_equal(idx, np.arange(6))


def test_a_capture_follows_its_warm_up_whatever_ran_between_sweeps(
        stand_in):
    """One-batch sweeps with the plan caches emptied between them, as a
    round's fine-tune may evict the sweep's plans: the capture in the
    second sweep comes right after its own eager forward, so it finds
    every plan cached and makes no host-to-device copy."""
    sources = _sources()
    gen = PseudoLabelGenerator(sources, device="cpu")
    data = _Images(4, HW)
    want = _eager(sources, torch.from_numpy(data.images))
    stand_in.launches = 0
    for sweep in range(3):
        pyrpool._plan_cache.clear()
        resize_x2._taps_cache.clear()
        labels, confs, _ = gen(DataLoader(data, batch_size=4))
        np.testing.assert_array_equal(labels, want[0].numpy())
        np.testing.assert_array_equal(confs, want[1].numpy())
    n = len(sources)
    assert (gen.eager_forwards, gen.graph_captures, gen.graph_replays) == (
        2 * n, n, n)
    assert stand_in.launches == 3 * sum(LAUNCHES)
