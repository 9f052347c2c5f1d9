"""The port's program spans (`utils/profiling.py::span`) on the CPU: a
channel-major sweep over the port's `DataLoader` and one train step emit
their `mspl.*` spans where the work happens, once a batch or step, on the
calling thread, and a SegFormer's forward its `mspl.segformer.*` spans,
one a stage's embedding, block branch and head; with no profiler running
no span reaches `record_function`, and the outputs do not depend on
whether a profiler runs."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from mspl_tpu_torch.data.loader import DataLoader
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import create_train_state, make_train_step
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.models.segformer import SegFormer
from mspl_tpu_torch.pseudo import cbst
from mspl_tpu_torch.pseudo.generate import PseudoLabelGenerator, make_source
from mspl_tpu_torch.utils import profiling

HW = (32, 48)
SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))
N_IMAGES, BATCH = 6, 4  # two batches, the tail one padded
TRAIN = ["mspl.train.upload", "mspl.train.augment", "mspl.train.forward",
         "mspl.train.loss", "mspl.train.backward", "mspl.train.optimizer"]
CBST = ["mspl.cbst.histograms", "mspl.cbst.kc", "mspl.cbst.sweep_kc",
        "mspl.cbst.apply_kc"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Images:
    """Seeded uint8 images with labels in {0, 1, 2}, a fifth ignored."""

    def __init__(self, n=N_IMAGES, seed=4):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8)
        lab = rng.integers(0, 3, (n, *HW))
        self.labels = np.where(rng.random((n, *HW)) < 0.2, 255,
                               lab).astype(np.int32)

    def __len__(self):
        return len(self.images)

    def load(self, i):
        return self.images[i], self.labels[i]


@pytest.fixture(scope="module")
def generator():
    torch.manual_seed(0)
    sources = [make_source(name, ESPNetv2Segmentation(c, s=0.5,
                                                      dec_base_planes=8),
                           None, name, channel_major=True, device="cpu")
               for name, c in SOURCES]
    return PseudoLabelGenerator(sources, mode="soft",
                                kc=np.full(3, 0.3, np.float32), device="cpu")


def _sweep(gen):
    """A sweep on the device path, then the CBST calls on its outputs."""
    labels, confs, _ = gen(DataLoader(_Images(), batch_size=BATCH,
                                      num_workers=1), return_device=True)
    hist = cbst.class_confidence_histograms(labels, confs, 3)
    kc = cbst.kc_from_histograms(hist, 0.5)
    kc_sweep = cbst.sweep_kc(labels, confs, 3, 0.5)
    thr = cbst.apply_kc_device(labels, confs, kc)
    return labels, confs, hist, kc, kc_sweep, thr


def _step_once():
    """One SGD train step with augmentation from fixed weights: (loss, the
    parameters after it)."""
    torch.manual_seed(1)
    model = ESPNetv2Segmentation(3, s=0.5, dec_base_planes=8)
    state = create_train_state(model, "sgd", build_schedule("poly", 0.01, 4),
                               device="cpu")
    step = make_train_step(model, crop_hw=HW, scale_range=(0.8, 1.2),
                           class_weights=[1.0, 2.0, 3.0], reg_mode="kld",
                           reg_weight=0.1, device="cpu")
    data = _Images(n=2, seed=7)
    batch = {"image": data.images, "label": data.labels,
             "valid": np.array([True, False])}
    state, out = step(state, batch, torch.Generator().manual_seed(3))
    return out["loss"], [p.detach().clone() for p in model.parameters()]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.caller"):
            out = fn()
    return out, [e for e in prof.events()
                 if e.name.startswith(("mspl.", "test.caller"))]


def test_sweep_emits_its_spans_once_a_batch(generator):
    _, events = _profiled(lambda: _sweep(generator))
    count = Counter(e.name for e in events)
    batches = -(-N_IMAGES // BATCH)
    assert count["mspl.loader.wait"] == batches
    assert count["mspl.generate.put"] == batches
    for name, _ in SOURCES:
        assert count[f"mspl.generate.model:{name}"] == batches
    # sweep_kc calls the histograms and kc inside its own span
    assert [count[n] for n in CBST] == [2, 2, 1, 1]
    caller = {e.thread for e in events if e.name == "test.caller"}
    assert {e.thread for e in events} == caller


def test_train_step_emits_six_spans_in_order():
    _, events = _profiled(_step_once)
    train = sorted((e for e in events if e.name.startswith("mspl.train.")),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in train] == TRAIN
    for a, b in zip(train, train[1:]):
        assert a.time_range.end <= b.time_range.start
    caller = {e.thread for e in events if e.name == "test.caller"}
    assert {e.thread for e in train} == caller


def test_no_profiler_no_record_function(generator, monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("mspl.a") is profiling.span("mspl.b")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")
    monkeypatch.setattr(profiling, "record_function", refuse)
    _sweep(generator)
    _step_once()


def test_outputs_do_not_depend_on_the_profiler(generator):
    plain = _sweep(generator), _step_once()
    traced, _ = _profiled(lambda: (_sweep(generator), _step_once()))
    (sweep_a, (loss_a, params_a)), (sweep_b, (loss_b, params_b)) = \
        plain, traced
    for a, b in zip(sweep_a, sweep_b):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert torch.equal(a, b)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


def test_segformer_forward_emits_its_spans_and_costs_nothing_without(
        monkeypatch):
    depths = (1, 2, 1, 1)
    torch.manual_seed(0)
    model = SegFormer(3, embed_dims=(8, 16, 24, 32), num_heads=(1, 2, 3, 4),
                      depths=depths, decoder_dim=16).eval()
    x = torch.randn(1, 3, 64, 96)
    with torch.no_grad():
        traced, events = _profiled(lambda: model(x))
        count = Counter(e.name for e in events
                        if e.name.startswith("mspl.segformer."))
        want = {"mspl.segformer.head": 1}
        for i, d in enumerate(depths, start=1):
            want.update({f"mspl.segformer.embed:{i}": 1,
                         f"mspl.segformer.attn:{i}": d,
                         f"mspl.segformer.ffn:{i}": d})
        assert dict(count) == want
        caller = {e.thread for e in events if e.name == "test.caller"}
        assert {e.thread for e in events} == caller

        def refuse(name):
            raise AssertionError(f"record_function({name!r}) with tracing "
                                 "off")
        monkeypatch.setattr(profiling, "record_function", refuse)
        assert torch.equal(model(x), traced)
