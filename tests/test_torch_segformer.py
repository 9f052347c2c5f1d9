"""The port's SegFormer (`models/segformer.py`) on the CPU at a tiny size,
held to the benchmark's plain reference (`h100_bench/reference/models/
segformer.py`, the paper's equations) on seeded weights: eval logits, a
train step's loss, every gradient and one SGD step; drop-path and head
dropout; `init_model`'s laws against the reference's `weight_law`; its
flax-layout checkpoints saved and resumed bit for bit; a self-training
round with a SegFormer target, its round-1 forward captured by the
generator and its fine-tunes' steps by the train step; the command line's
`train --model segformer`; and the espnetv2-only flags refusing it."""

import math
import os
from collections import Counter

import numpy as np
import pytest
import torch

import mspl_tpu_torch.models as port_models
from h100_bench.reference import pipeline as ref
from h100_bench.weights import make_state, shapes_of
from mspl_tpu_torch.cli import load_model_checkpoint, main
from mspl_tpu_torch.data.transforms import normalize
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import (create_train_state,
                                         make_train_step,
                                         restore_train_state,
                                         train_state_tree)
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.models.factory import build_segmentation_model, init_model
from mspl_tpu_torch.models import segformer
from mspl_tpu_torch.models.segformer import SegFormer, drop_path
from mspl_tpu_torch.pseudo import generate, self_training
from mspl_tpu_torch.pseudo.generate import make_source
from mspl_tpu_torch.pseudo.self_training import SelfTrainConfig
from mspl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from mspl_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables)
from mspl_tpu_torch.utils.registry import MODEL_NAMES

from tests.test_torch_cli import _make_png_dataset
from tests.torch_graph_stand_in import StandInGraph, take_graph_path

TINY = dict(embed_dims=(16, 32, 40, 64), num_heads=(1, 2, 5, 8),
            depths=(1, 1, 2, 1), decoder_dim=32)
SPEC = dict(name="segformer", **TINY)
CLASSES, SEED = 3, 2 ** 31 + 11
HW = (64, 96)
ODD_HW = (72, 104)  # every stage's map has sides that R does not divide
CPU = torch.device("cpu")
# f32 against f32 of the same function in another order of sums: the
# logits' gap to the reference reads 3e-7 of their norm (each side 3-4e-7
# against the reference in f64), the TF32 control's 5e-4
LOGIT_TOL = 1e-5
# a step's loss: the port's reads 0, the TF32 control's 1.6e-6
LOSS_TOL = 2e-7
# each gradient and each parameter's change after the SGD step (lr 0.5,
# so that the change is not lost in the parameters' own f32 spacing): the
# norm of its difference over max(its norm, the median leaf's); read up
# to 4.2e-5 (the reductions' weights: a strided convolution against Eq.
# 2's linear layer sums in another order), the TF32 control's 1.6e-2
LEAF_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state(seed=SEED):
    with torch.device("meta"):
        shapes = shapes_of(ref.build_model(SPEC, CLASSES, torch.float32))
    return make_state("segformer", shapes, seed, CPU)


def _pair(**kw):
    state = _state()
    port = build_segmentation_model("segformer", CLASSES, **TINY, **kw)
    plain = ref.build_model(SPEC, CLASSES, torch.float32)
    port.load_state_dict(state)
    plain.load_state_dict(state)
    return port, plain


def sdpa_calls(monkeypatch) -> Counter:
    """Counts the eager calls of `F.scaled_dot_product_attention` by the
    backend torch picks; a CUDA graph's capture is not counted."""
    calls = Counter()
    real = torch.nn.functional.scaled_dot_product_attention

    def counted(q, k, v, *args, scale=None, **kw):
        if not (q.is_cuda and torch.cuda.is_current_stream_capturing()):
            calls[segformer._sdpa_backend(q, k, v, scale)] += 1
        return real(q, k, v, *args, scale=scale, **kw)

    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        counted)
    return calls


def _images(n, hw, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *hw, 3), generator=g, dtype=torch.uint8)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_registry_and_factory_build_b5():
    assert "segformer" in MODEL_NAMES
    with torch.device("meta"):
        model = build_segmentation_model("segformer", CLASSES)
    assert isinstance(model, SegFormer)
    n = sum(p.numel() for p in model.parameters())
    assert round(n / 1e6, 1) == 84.6
    assert [len(model.backbone.block3), model.decode_head.linear_fuse.conv
            .in_channels] == [40, 4 * 768]


@pytest.mark.parametrize("hw", [HW, ODD_HW], ids=["64x96", "72x104"])
def test_eval_logits_match_the_reference(hw, monkeypatch):
    port, plain = _pair()
    x = normalize(_images(2, hw))
    with torch.no_grad():
        want = plain.eval()(x)
        calls = sdpa_calls(monkeypatch)
        got = port.eval()(x)
    assert got.dtype == torch.float32 and got.shape == (2, CLASSES, *hw)
    assert _rel(got, want) <= LOGIT_TOL
    assert sum(calls.values()) == sum(TINY["depths"])
    assert all(k.startswith("sdpa:") for k in calls)


def _leaf_gaps(got, want):
    """Each leaf's norm of the difference over the larger of its norm and
    the median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    return {k: float((got[k].double() - want[k].double()).norm())
            / max(norms[k], med) for k in want}


def test_train_step_matches_the_reference():
    """One SGD step of the engine's train step (no augmentation) against
    the reference's loss, gradients and SGD on the same batch."""
    port, plain = _pair()
    init = {k: v.detach().clone() for k, v in port.named_parameters()}
    imgs = _images(2, HW, seed=1)
    labels = torch.randint(0, CLASSES, (2, *HW),
                           generator=torch.Generator().manual_seed(2))
    labels[:, ::3] = 255
    cw = np.array([1.0, 2.0, 3.0], np.float32)
    lr, momentum, wd = 0.5, 0.9, 4e-5
    state = create_train_state(port, "sgd", build_schedule("fixed", lr, 4),
                               momentum, wd, device="cpu")
    step = make_train_step(port, class_weights=cw, reg_mode="kld",
                           reg_weight=0.1, augment=False, device="cpu")
    state, out = step(state, {"image": imgs.numpy(),
                              "label": labels.numpy()})

    plain.train()
    params = dict(plain.named_parameters())
    loss = ref.loss_fn(plain(ref.normalize(imgs)), labels,
                       torch.from_numpy(cw), 0.1)
    grads = torch.autograd.grad(loss, list(params.values()))
    ref.sgd_step(list(params.values()), grads, [None] * len(grads), lr,
                 momentum, wd)

    loss = loss.item()
    assert abs(float(out["loss"]) - loss) <= LOSS_TOL * loss
    got_g = {k: p.grad for k, p in port.named_parameters()}
    assert max(_leaf_gaps(got_g, dict(zip(params, grads))).values()) \
        <= LEAF_TOL
    moved = {k: p.detach() - init[k] for k, p in port.named_parameters()}
    want = {k: p.detach() - init[k] for k, p in params.items()}
    assert max(_leaf_gaps(moved, want).values()) <= LEAF_TOL
    # the train step runs the model in f32 and leaves TF32 as it was
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert not torch.backends.cuda.matmul.allow_tf32


def test_drop_path_is_per_sample_and_identity_in_eval():
    x = torch.ones(64, 5, 7)
    assert drop_path(x, 0.5, False) is x and drop_path(x, 0.0, True) is x
    torch.manual_seed(0)
    y = drop_path(x, 0.5, True)
    per_sample = y.flatten(1)
    assert torch.equal(per_sample.amin(1), per_sample.amax(1))
    assert set(per_sample[:, 0].tolist()) == {0.0, 2.0}


def test_drop_path_and_head_dropout_act_in_train_only():
    port, _ = _pair()
    noisy = build_segmentation_model("segformer", CLASSES,
                                     drop_path_rate=0.3, head_dropout=0.5,
                                     **TINY)
    noisy.load_state_dict(port.state_dict())
    blocks = [b for i in range(1, 5)
              for b in getattr(noisy.backbone, f"block{i}")]
    # stochastic depth rises linearly over the blocks, as published
    np.testing.assert_allclose([b.drop_path for b in blocks],
                               np.linspace(0, 0.3, len(blocks)))
    x = normalize(_images(2, HW))
    with torch.no_grad():
        assert torch.equal(noisy.eval()(x), port.eval()(x))
        noisy.train()
        port.train()
        torch.manual_seed(5)
        a = noisy(x)
        torch.manual_seed(5)
        b = noisy(x)
        torch.manual_seed(5)
        c = port(x)
    assert torch.equal(a, b) and not torch.allclose(a, c)


def test_init_draws_the_reference_laws():
    """`init_model`'s draw of each leaf against the reference's
    `weight_law` for it: constants exactly; normals by their sample std
    (within 4 standard errors of the law's), pooled into one unit normal
    that is not cut at 2 std."""
    law_of = ref.model_module("segformer").weight_law
    model = init_model(build_segmentation_model("segformer", CLASSES,
                                                **TINY),
                       torch.Generator().manual_seed(0))
    pooled = []
    for name, t in model.state_dict().items():
        law, value = law_of(name, tuple(t.shape))
        if law == "const":
            assert torch.all(t == value), name
            continue
        assert law == "normal", name
        z = t.double().flatten() / value
        pooled.append(z)
        if z.numel() >= 64:
            assert abs(float(z.std()) - 1) <= 4 / math.sqrt(2 * z.numel()), \
                name
    z = torch.cat(pooled)
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02
    assert float(z.abs().max()) > 3


def test_checkpoint_saves_and_resumes_bit_for_bit(tmp_path):
    """A train state after one SGD step, saved in the flax layout and
    restored into a fresh state, takes the next step to the same bits."""
    imgs = _images(2, HW, seed=3).numpy()
    batch = {"image": imgs, "label": np.full((2, *HW), 1, np.int32)}

    def fresh():
        model = build_segmentation_model("segformer", CLASSES, **TINY)
        init_model(model, torch.Generator().manual_seed(1))
        state = create_train_state(model, "sgd",
                                   build_schedule("poly", 0.01, 8),
                                   device="cpu")
        return state, make_train_step(model, HW, (0.8, 1.2), device="cpu")

    state, step = fresh()
    state, _ = step(state, batch, torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path), train_state_tree(state), {"epoch": 0})
    tree, _ = load_checkpoint(str(tmp_path))
    twin, twin_step = fresh()
    restore_train_state(twin, tree)
    for a, b in zip(state.model.state_dict().values(),
                    twin.model.state_dict().values()):
        assert torch.equal(a, b)
    state, _ = step(state, batch, torch.Generator().manual_seed(1))
    twin, _ = twin_step(twin, batch, torch.Generator().manual_seed(1))
    for a, b in zip(state.model.parameters(), twin.model.parameters()):
        assert torch.equal(a, b)
    # and the model's variables alone
    other = build_segmentation_model("segformer", CLASSES, **TINY)
    load_flax_variables(other, flax_variables(state.model))
    for (k, a), b in zip(state.model.state_dict().items(),
                         other.state_dict().values()):
        assert k.endswith("num_batches_tracked") or torch.equal(a, b), k


class _Target:
    """Unlabeled target images (`load` gives every pixel ignored)."""

    def __init__(self, n, hw):
        self.images = _images(n, hw, seed=9).numpy()
        self.shape_hw = hw

    def __len__(self):
        return len(self.images)

    def load(self, i):
        return self.images[i], np.full(self.shape_hw, 255, np.uint8)


def test_self_training_round_with_a_segformer_target(monkeypatch):
    """Two rounds: round 0 on the sources alone, round 1 with the tuned
    SegFormer in the ensemble, whose forward the generator captures on its
    second batch and replays after, while the fine-tunes capture and
    replay the train step's forward and backward (the CUDA graph a
    stand-in here)."""
    made = []

    class Recording(generate.PseudoLabelGenerator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    take_graph_path(monkeypatch)
    monkeypatch.setattr(self_training, "PseudoLabelGenerator", Recording)
    torch.manual_seed(0)
    sources = [make_source(name, ESPNetv2Segmentation(c, s=0.5,
                                                      dec_base_planes=8),
                           None, name, channel_major=True, device="cpu")
               for name, c in (("camvid", 11), ("forest", 5))]
    model = init_model(build_segmentation_model("segformer", CLASSES,
                                                **TINY),
                       torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = SelfTrainConfig(rounds=2, p_init=0.5, batch_size=2,
                          epochs_per_round=1, crop_hw=HW, verbose=False)
    res = self_training.self_training(model, None, sources,
                                      _Target(6, HW), None, CLASSES, cfg,
                                      device="cpu")
    assert [h["n_sources"] for h in res["history"]] == [2, 3]
    tgt = made[1]
    assert isinstance(tgt.sources[2].model, SegFormer)
    # three batches a sweep: two eager (the second captures), one replayed
    assert (tgt.graph_captures, tgt.graph_replays) == (3, 3)
    assert sorted(tgt._graphs[((2, 3, *HW), torch.float32, CPU)]) == [0, 1,
                                                                        2]
    assert any(g.grad_call is not None for g in StandInGraph.made)
    after = res["model"].state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)


@pytest.fixture
def tiny_segformer(monkeypatch):
    """The factory builds a tiny SegFormer under the name `segformer`."""
    build = port_models.build_segmentation_model

    def tiny(name, *a, **kw):
        if name == "segformer":
            kw = {**TINY, **kw}
        return build(name, *a, **kw)
    monkeypatch.setattr(port_models, "build_segmentation_model", tiny)


def test_cli_trains_and_reloads_a_segformer(tmp_path, tiny_segformer):
    root = _make_png_dataset(str(tmp_path / "gh"), "greenhouse", CLASSES,
                             n=4, size_wh=(HW[1], HW[0]))
    ck = str(tmp_path / "ckpt")
    res = main(["train", "--dataset", "greenhouse", "--data-root", root,
                "--train-list", os.path.join(root, "list.txt"),
                "--model", "segformer", "--ckpt-dir", ck, "--size",
                str(HW[1]), str(HW[0]), "--batch-size", "2", "--epochs",
                "1", "--lr", "0.005", "--scheduler", "fixed"], device="cpu")
    assert [h["epoch"] for h in res["history"]] == [0]
    model, _, meta = load_model_checkpoint(ck)
    assert meta["model"] == "segformer" and isinstance(model, SegFormer)
    for a, b in zip(res["state"].model.parameters(), model.parameters()):
        assert torch.equal(a.detach(), b.detach())


TRAIN = ["train", "--dataset", "greenhouse", "--data-root", "r",
         "--train-list", "l", "--model", "segformer"]


@pytest.mark.parametrize("argv,match", [
    (TRAIN + ["--cm-decoder"], "espnetv2-only"),
    (TRAIN + ["--pretrained-encoder", "p"], "espnetv2"),
    (["selftrain", "--checkpoints", "c", "--data-root", "r",
      "--target-list", "t", "--cm-decoder", "--model", "segformer"],
     "espnetv2-only"),
    (["import-torch", "--pth", "p", "--model", "segformer",
      "--num-classes", "3", "--out-dir", "o"], "invalid choice"),
], ids=["cm-decoder", "pretrained-encoder", "selftrain-cm-decoder",
        "import-torch"])
def test_espnetv2_only_flags_refuse_segformer(argv, match, capsys):
    with pytest.raises(SystemExit, match=None if "choice" in match
                       else match):
        main(argv, device="cpu")
    if "choice" in match:
        assert match in capsys.readouterr().err

