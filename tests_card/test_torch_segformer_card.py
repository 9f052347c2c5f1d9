"""SegFormer-B5 at its published widths on the card, in f32 with TF32 off:
the eval forward at batch 8 against the benchmark's plain reference (its
gap a small share of the reference's own gap in the TF32 control's
precision), attention's two products against f64 beside the TF32
control's rounding, and a round-1 sweep with a SegFormer target whose
forward replays from the generator's CUDA graph with the eager forward's
labels, its eager attention calls counted apart from the graph's
capture."""

from collections import Counter

import numpy as np
import pytest
import torch

from h100_bench.reference import layers as ref_layers
from h100_bench.reference.pipeline import build_model
from h100_bench.weights import make_state, shapes_of
from mspl_tpu_torch.models import segformer
from mspl_tpu_torch.models.factory import build_segmentation_model, init_model
from mspl_tpu_torch.ops import graphs
from mspl_tpu_torch.pseudo.generate import PseudoLabelGenerator, make_source

HW, BATCH, CLASSES = (256, 480), 8, 3
BLOCKS = 3 + 6 + 40 + 3
# the port's logits gap to the reference, at most this share of the
# reference's own gap when its products round to TF32
SHARE_OF_TF32 = 0.1
CONF_TOL = 1e-5
# (tokens, kv tokens, heads, head width) of B5's four stages at 256x480
STAGES = ((64 * 120, 120, 1, 64), (32 * 60, 120, 2, 64),
          (16 * 30, 120, 5, 64), (8 * 15, 120, 8, 64))


@pytest.fixture(autouse=True)
def _no_tf32():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def sdpa_calls(monkeypatch) -> Counter:
    """Counts the eager calls of `F.scaled_dot_product_attention` by the
    backend torch picks; a CUDA graph's capture is not counted (as in
    `tests/test_torch_segformer.py`, which imports JAX)."""
    calls = Counter()
    real = torch.nn.functional.scaled_dot_product_attention

    def counted(q, k, v, *args, scale=None, **kw):
        if not (q.is_cuda and torch.cuda.is_current_stream_capturing()):
            calls[segformer._sdpa_backend(q, k, v, scale)] += 1
        return real(q, k, v, *args, scale=scale, **kw)

    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        counted)
    return calls


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.card
def test_eval_forward_matches_the_reference(card, monkeypatch):
    spec = {"name": "segformer"}
    with torch.device("meta"):
        shapes = shapes_of(build_model(spec, CLASSES, torch.float32))
    state = make_state("segformer", shapes, 2 ** 31 + 5, card)
    port = build_segmentation_model("segformer", CLASSES).to(card)
    port.load_state_dict(state)
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(BATCH, 3, *HW, generator=g, device=card)
    gaps = {}
    with torch.no_grad():
        want = None
        for name, num in (("plain", ref_layers.PLAIN),
                          ("tf32", ref_layers.TF32Numerics())):
            ref = build_model(spec, CLASSES, torch.float32, num).to(card)
            ref.load_state_dict(state)
            out = ref.eval()(x)
            if want is None:
                want = out
            else:
                gaps[name] = _rel(out, want)
            del ref
        calls = sdpa_calls(monkeypatch)
        got = port.eval()(x)
    gaps["port"] = _rel(got, want)
    print(f"eval logits, relative gap to the reference: {gaps}; "
          f"attention calls {dict(calls)}")
    assert got.dtype == torch.float32 and got.shape == (BATCH, CLASSES, *HW)
    assert gaps["port"] <= SHARE_OF_TF32 * gaps["tf32"], gaps
    assert sum(calls.values()) == BLOCKS


@pytest.mark.card
@pytest.mark.parametrize("stage", range(4))
def test_attention_products_round_below_tf32(card, stage):
    n, m, heads, d = STAGES[stage]
    g = torch.Generator(device=card).manual_seed(stage)
    q, k, v = (torch.randn(BATCH, heads, t, d, generator=g, device=card)
               for t in (n, m, m))
    scale = d ** -0.5

    def plain(a, b, c, rnd=lambda t: t):
        att = torch.softmax(rnd(a) @ rnd(b).transpose(-2, -1) * scale, -1)
        return rnd(att) @ rnd(c)

    want = plain(q.double(), k.double(), v.double())
    sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                            scale=scale)
    gaps = {"sdpa": _rel(sdpa, want),
            "tf32": _rel(plain(q, k, v, ref_layers.tf32_round), want)}
    backend = segformer._sdpa_backend(q, k, v, scale)
    print(f"stage {stage + 1}: {backend}, relative gap to f64 {gaps}")
    assert gaps["sdpa"] <= SHARE_OF_TF32 * gaps["tf32"], (backend, gaps)


def _espnet(classes, seed):
    model = build_segmentation_model("espnetv2", classes, s=2.0,
                                     compute_dtype=torch.bfloat16)
    return init_model(model, torch.Generator().manual_seed(seed))


def _sources(target):
    identity = np.concatenate([np.eye(CLASSES, dtype=np.float32),
                               np.zeros((CLASSES, 1), np.float32)], axis=1)
    return [make_source("camvid", _espnet(11, 0), None, "camvid",
                        channel_major=True, device="cuda"),
            make_source("target", target, None, "greenhouse",
                        num_target=CLASSES, channel_major=True,
                        conversion=identity, compute_dtype=None,
                        device="cuda")]


@pytest.mark.card
def test_round1_sweep_replays_the_segformer_target(card, monkeypatch):
    target = init_model(build_segmentation_model("segformer", CLASSES),
                        torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(0)
    batches = [torch.randint(0, 256, (BATCH, *HW, 3), generator=g,
                             dtype=torch.uint8).cuda() for _ in range(4)]
    runs = {}
    for mode in ("eager", "graphs"):
        with monkeypatch.context() as mp:
            if mode == "eager":
                mp.setattr(graphs, "graphable", lambda x: False)
            calls = sdpa_calls(mp)
            sources = _sources(target)
            gen = PseudoLabelGenerator(sources, device="cuda")
            out = [tuple(t.clone() for t in gen.batch_pass(b))
                   for b in batches]
            torch.cuda.synchronize()
        runs[mode] = (out, gen.graph_captures, gen.graph_replays,
                      sum(calls.values()))
        print(f"{mode}: captures {gen.graph_captures}, replays "
              f"{gen.graph_replays}, target attention calls {dict(calls)}")
    eager, replayed = runs["eager"], runs["graphs"]
    assert eager[1:] == (0, 0, 4 * BLOCKS)
    # two eager batches (the second captures), two replayed, each source
    assert replayed[1:] == (2, 4, 2 * BLOCKS)
    for (lab, conf), (lab_e, conf_e) in zip(replayed[0], eager[0]):
        assert torch.equal(lab, lab_e)
        assert float((conf - conf_e).abs().max()) <= CONF_TOL
