"""The generator's CUDA graphs of the sources' forwards on the card, with
the round-1 ensemble of the self-training rounds at batch 8: three bf16
ESPNetv2-s2.0 sources and the f32 DeepLabV3-ResNet-50 target, channel-major,
256x480.  Replays give the eager path's labels and confidences, follow
`set_variables`, survive the plan caches being emptied and their memory
reused, and leave the kernel wrappers' launch counters where the eager
path leaves them."""

import numpy as np
import pytest
import torch

from mspl_tpu_torch.models.factory import build_segmentation_model, init_model
from mspl_tpu_torch.ops import graphs, pyrpool, resize_x2
from mspl_tpu_torch.pseudo.generate import PseudoLabelGenerator, make_source

HW, BATCH = (256, 480), 8
SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))
TARGET = 3
CONF_TOL = 1e-6


def _espnet(classes, seed):
    model = build_segmentation_model("espnetv2", classes, s=2.0,
                                     compute_dtype=torch.bfloat16)
    return init_model(model, torch.Generator().manual_seed(seed))


def _deeplab(seed):
    model = build_segmentation_model("deeplabv3", TARGET)
    return init_model(model, torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def ensemble():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sources = [make_source(name, _espnet(c, i), None, name,
                           channel_major=True, device="cuda")
               for i, (name, c) in enumerate(SOURCES)]
    identity = np.concatenate([np.eye(TARGET, dtype=np.float32),
                               np.zeros((TARGET, 1), np.float32)], axis=1)
    sources.append(make_source(
        "target", _deeplab(7), None, "greenhouse", num_target=TARGET,
        channel_major=True, conversion=identity, compute_dtype=None,
        device="cuda"))
    return sources


def _batches(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (BATCH, *HW, 3), generator=g,
                          dtype=torch.uint8).cuda() for _ in range(n)]


def _run(gen, batches):
    out = [gen.batch_pass(b) for b in batches]
    torch.cuda.synchronize()
    return [(lab.clone(), conf.clone()) for lab, conf in out]


def _eager(sources, batches, monkeypatch):
    with monkeypatch.context() as mp:
        mp.setattr(graphs, "graphable", lambda x: False)
        gen = PseudoLabelGenerator(sources, device="cuda")
        out = _run(gen, batches)
    assert gen.graph_captures == gen.graph_replays == 0
    return out


def _same(got, want):
    for (lab, conf), (lab_e, conf_e) in zip(got, want):
        assert torch.equal(lab, lab_e)
        assert float((conf - conf_e).abs().max()) <= CONF_TOL


@pytest.mark.card
def test_replay_matches_eager(card, ensemble, monkeypatch):
    # two eager batches (the second captures), then three replayed
    batches = _batches(5)
    want = _eager(ensemble, batches, monkeypatch)
    gen = PseudoLabelGenerator(ensemble, device="cuda")
    got = _run(gen, batches)
    n = len(ensemble)
    assert (gen.eager_forwards, gen.graph_captures, gen.graph_replays) == (
        2 * n, n, 3 * n)
    _same(got, want)


@pytest.mark.card
def test_replay_follows_set_variables(card, ensemble, monkeypatch):
    gen = PseudoLabelGenerator(ensemble, device="cuda")
    _run(gen, _batches(2, seed=1))
    old = [{k: v.clone() for k, v in ensemble[i].model.state_dict().items()}
           for i in (1, 3)]
    try:
        gen.set_variables(1, _espnet(SOURCES[1][1], 21).state_dict())
        gen.set_variables(3, _deeplab(23).state_dict())
        batches = _batches(4, seed=2)
        got = _run(gen, batches)
        # 1 and 3 run eagerly twice, 2 (captured before 1) once more, and
        # the three capture again; the last two batches replay all four
        assert gen.graph_captures == len(ensemble) + 3
        assert gen.graph_replays == 1 + 2 + 2 * len(ensemble)
        _same(got, _eager(ensemble, batches, monkeypatch))
    finally:
        for i, state in zip((1, 3), old):
            ensemble[i].model.load_state_dict(state)


@pytest.mark.card
def test_replay_outlives_the_plan_caches(card, ensemble):
    gen = PseudoLabelGenerator(ensemble, device="cuda")
    batches = _batches(3, seed=3)
    want = _run(gen, batches)[2]
    pyrpool._plan_cache.clear()
    resize_x2._taps_cache.clear()
    torch.cuda.empty_cache()
    junk = [torch.full((64 << 20,), float("nan"), device="cuda")
            for _ in range(8)]
    got = _run(gen, batches[2:])[0]
    del junk
    assert gen.graph_replays == 2 * len(ensemble)
    _same([got], [want])


@pytest.mark.card
def test_launch_counters_count_kernel_runs(card, ensemble, monkeypatch):
    batches = _batches(4, seed=4)

    def counts(run):
        counters = graphs.launch_counters()
        for fn in counters:
            fn.launches = 0
        run()
        return {fn.__name__: fn.launches for fn in counters}

    gen = PseudoLabelGenerator(ensemble, device="cuda")
    graphed = counts(lambda: _run(gen, batches))
    assert gen.graph_replays == 2 * len(ensemble)
    eager = counts(lambda: _eager(ensemble, batches, monkeypatch))
    assert graphed == eager
    # the sweep cells' expectation: 3, 9, 3 and 1 a batch
    assert (eager["pyr_pool_fused_eval"], eager["pyr_branches"],
            eager["resize_x2_cm"], eager["fused_pseudo_cm"]) == (
        12, 36, 12, 4)
