"""The port's self-training round against the JAX package on the CPU.

Two rounds of `self_training` run in each package from the same flax
trees: three tiny ESPNetv2 (s=0.5) sources (CamVid 11, Cityscapes 19,
Forest 5 classes) through the flax bridge, a 3-class target model (an
ESPNetv2, or a small DeepLabV3: the backbone swap of config #5), and a
synthetic unlabeled target set at 32x48.  The train-time augmentation
cannot draw the same crops in both packages (a PRNG key against a
torch.Generator; the transforms are held against each other at the same
draws in tests/test_torch_transforms.py), so `TrainLoopConfig.augment` is
patched off on both sides for the run (the JAX module's name is patched at
run time; no file of it changes).  Each round's thresholded labels are
caught where they enter `PseudoLabeledDataset`, and the rounds also dump
them as PNGs through `out_dir`.

Besides: the CBST re-threshold and kc sweep against the JAX package's, the
pseudo-labeled dataset, the fused passes on a mixed bf16 + f32 ensemble
(a round's sources and target model) against the JAX kernels in interpret
mode, and the target member's own module."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data.datasets import SyntheticSegmentation as JaxSynthetic
from mspl_tpu.data.label_space import label_conversion_matrix
from mspl_tpu.engine import train as jax_train
from mspl_tpu.models import DeepLabV3 as FlaxDeepLab
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu.ops.pallas_pseudo import fused_pseudo_pass_pallas
from mspl_tpu.ops.pallas_pseudo_cm import fused_pseudo_cm as jax_pseudo_cm
from mspl_tpu.pseudo import cbst as jax_cbst
from mspl_tpu.pseudo import generate as jax_gen
from mspl_tpu_torch.data.datasets import SyntheticSegmentation
from mspl_tpu_torch.engine import train as port_train
from mspl_tpu_torch.models.deeplab import DeepLabV3
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.ops.pseudo import fused_pseudo_pass_plain
from mspl_tpu_torch.ops.pseudo_cm import fused_pseudo_cm_plain
from mspl_tpu_torch.parallel.mesh import make_mesh
from mspl_tpu_torch.pseudo import cbst
from mspl_tpu_torch.pseudo import generate as port_gen
from mspl_tpu_torch.pseudo import self_training as port_st
from mspl_tpu_torch.pseudo.self_training import (PseudoLabeledDataset,
                                                 SelfTrainConfig,
                                                 self_training)
from tests.test_torch_model import flax_variables

jax_st = importlib.import_module("mspl_tpu.pseudo.self_training")

HW = (32, 48)
SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))
CLASSES = 3
N_TARGET, BATCH = 8, 4
ROUND_KW = dict(rounds=2, batch_size=BATCH, epochs_per_round=1, crop_hw=HW,
                verbose=False)
BIN = 1.0 / cbst.DEFAULT_BINS
# the target model of each package, by registry name: (flax, port)
TARGETS = {
    "espnetv2": (
        lambda: FlaxESPNetv2(num_classes=CLASSES, s=0.5, dec_base_planes=8,
                             channel_major_logits=True),
        lambda: ESPNetv2Segmentation(CLASSES, s=0.5, dec_base_planes=8)),
    "deeplabv3": (
        lambda: FlaxDeepLab(num_classes=CLASSES, stage_blocks=(1, 1, 1, 1),
                            aspp_features=16),
        lambda: DeepLabV3(CLASSES, stage_blocks=(1, 1, 1, 1),
                          aspp_features=16)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's CPU ops on two threads for this module: the tests run in
    several workers on one host, where small ops on as many threads as
    cores mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _source_trees():
    out = []
    for i, (name, c) in enumerate(SOURCES):
        model = FlaxESPNetv2(num_classes=c, s=0.5, dec_base_planes=8)
        v = flax_variables(model, HW, 10 + i)
        # spread the fused confidences over (0, 1) (see test_torch_generate)
        v["params"]["bu_dec_l4"]["classify"]["Conv_0"]["kernel"] *= 20.0
        out.append((name, c, model, v))
    return out


def _no_augment(cfg_cls, **fixed):
    """The round's train-loop config with augmentation off and `fixed`
    fields set (on the JAX side the state dispatched leaf by leaf,
    `pack_dispatch=False`: the same math, and a quarter less compile time
    here)."""
    fields = {"augment": False, **fixed}
    return dataclasses.make_dataclass(
        "TrainLoopConfig", [(k, type(v), v) for k, v in fields.items()],
        bases=(cfg_cls,))


def _catching(ds_cls, caught):
    class Catching(ds_cls):
        def __init__(self, base_ds, labels, indices):
            caught.append((labels.copy(), indices.copy()))
            super().__init__(base_ds, labels, indices)
    return Catching


def _target_sets(synthetic):
    return synthetic(CLASSES, (HW[1], HW[0]), N_TARGET, seed=3,
                     unlabeled=True)


@pytest.fixture(scope="module", params=sorted(TARGETS, reverse=True))
def rounds(tmp_path_factory, request):
    sources = _source_trees()
    make_flax, make_port = TARGETS[request.param]
    target = make_flax()
    target_vars = flax_variables(target, HW, 20)
    caught = {"jax": [], "port": []}
    dirs = {k: tmp_path_factory.mktemp(k) for k in caught}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_st, "TrainLoopConfig",
                   _no_augment(jax_train.TrainLoopConfig,
                               pack_dispatch=False))
        mp.setattr(port_st, "TrainLoopConfig",
                   _no_augment(port_train.TrainLoopConfig))
        mp.setattr(jax_st, "PseudoLabeledDataset",
                   _catching(jax_st.PseudoLabeledDataset, caught["jax"]))
        mp.setattr(port_st, "PseudoLabeledDataset",
                   _catching(port_st.PseudoLabeledDataset, caught["port"]))
        want = jax_st.self_training(
            target, target_vars,
            [jax_gen.make_source(n, m, v, n, channel_major=True)
             for n, _, m, v in sources],
            _target_sets(JaxSynthetic), None, CLASSES,
            jax_st.SelfTrainConfig(out_dir=str(dirs["jax"]), **ROUND_KW))
        got = self_training(
            make_port(), target_vars,
            [port_gen.make_source(n, ESPNetv2Segmentation(c, s=0.5,
                                                          dec_base_planes=8),
                                  v, n, channel_major=True, device="cpu")
             for n, c, _, v in sources],
            _target_sets(SyntheticSegmentation), None, CLASSES,
            SelfTrainConfig(out_dir=str(dirs["port"]), **ROUND_KW),
            device="cpu")
    return dict(want=want, got=got, caught=caught, dirs=dirs)


def test_round0_labels_and_kc_match_jax(rounds):
    """Round 0 (the three sources): thresholded labels bit-identical, kc
    and the kept share equal."""
    (wl, wi), (gl, gi) = rounds["caught"]["jax"][0], rounds["caught"]["port"][0]
    np.testing.assert_array_equal(gi, wi)
    assert gl.dtype == wl.dtype == np.int32
    np.testing.assert_array_equal(gl, wl)
    w0, g0 = rounds["want"]["history"][0], rounds["got"]["history"][0]
    assert g0["kc"] == w0["kc"]
    assert max(g0["kc"]) > 0.5  # kc thresholds something
    assert g0["frac_kept"] == w0["frac_kept"]
    assert 0.05 < g0["frac_kept"] < 0.6
    assert g0["n_sources"] == w0["n_sources"] == 3
    assert g0["p"] == w0["p"]


def test_round1_with_the_target_model_matches_jax(rounds):
    """Round 1 adds the fine-tuned target model to the ensemble (one
    fine-tune in between, fp32 sums in another order): kc within one
    histogram bin, labels at least 0.999 equal (measured: equal)."""
    (wl, wi), (gl, gi) = rounds["caught"]["jax"][1], rounds["caught"]["port"][1]
    np.testing.assert_array_equal(gi, wi)
    assert (gl == wl).mean() >= 0.999
    w1, g1 = rounds["want"]["history"][1], rounds["got"]["history"][1]
    assert g1["n_sources"] == w1["n_sources"] == 4
    np.testing.assert_allclose(g1["kc"], w1["kc"], rtol=0, atol=BIN)
    assert g1["p"] == w1["p"] > rounds["got"]["history"][0]["p"]
    assert abs(g1["frac_kept"] - w1["frac_kept"]) <= 1e-3


def test_round_dumps_match_jax(rounds):
    """`out_dir`: each round's labels as PNGs (the same pixels as the JAX
    package's dump) and a train list naming them."""
    from PIL import Image

    for r in range(2):
        wd, gd = (rounds["dirs"][k] / f"round{r}" for k in ("jax", "port"))
        names = sorted(p.name for p in gd.glob("pseudo_*.png"))
        assert names == sorted(p.name for p in wd.glob("pseudo_*.png"))
        assert len(names) == N_TARGET
        for name in names:
            got = np.asarray(Image.open(gd / name))
            assert got.dtype == np.uint8 and got.shape == HW
            np.testing.assert_array_equal(got,
                                          np.asarray(Image.open(wd / name)))
        lines = (gd / "train_list.txt").read_text().splitlines()
        assert len(lines) == N_TARGET
        assert lines[0] == f"index:0 {gd / 'pseudo_000000.png'}"


def test_round_results(rounds):
    """The port returns the tuned model and its state dict beside the
    history; with no val loader mIoU stays -1, as in the reference."""
    got = rounds["got"]
    assert set(got) == {"model", "variables", "history", "best_miou"}
    assert got["best_miou"] == rounds["want"]["best_miou"] == -1.0
    assert [h["round"] for h in got["history"]] == [0, 1]
    sd = got["model"].state_dict()
    assert all(torch.equal(sd[k], v) for k, v in got["variables"].items())


def _label_conf_set(seed, n=10, hw=(24, 32), t=CLASSES):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, t, (n, *hw)).astype(np.uint8)
    labels[rng.random(labels.shape) < 0.2] = 255
    confs = rng.random((n, *hw)).astype(np.float32)
    return labels, confs


@pytest.mark.parametrize("p", [0.2, 0.5, 1.0])
def test_sweep_and_apply_kc_match_jax(p):
    """`sweep_kc` and `apply_kc_device` against the JAX package's on a
    uint8 label set with ignore: kc and the re-thresholded labels
    bit-identical, the labels' dtype kept."""
    labels, confs = _label_conf_set(seed=int(p * 10))
    want_kc = jax_cbst.sweep_kc(jnp.asarray(labels), jnp.asarray(confs),
                                CLASSES, p)
    got_kc = cbst.sweep_kc(torch.from_numpy(labels), torch.from_numpy(confs),
                           CLASSES, p)
    np.testing.assert_array_equal(got_kc, want_kc)
    want = np.asarray(jax_cbst.apply_kc_device(jnp.asarray(labels),
                                               jnp.asarray(confs), want_kc))
    got = cbst.apply_kc_device(torch.from_numpy(labels),
                               torch.from_numpy(confs), got_kc)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if p < 1.0:
        assert (got.numpy() == 255).mean() > (labels == 255).mean()


def test_pseudo_labeled_dataset_round_trip():
    """Labels come back in index order with their images, as uint8."""
    base = SyntheticSegmentation(CLASSES, (16, 12), 5, seed=1, unlabeled=True)
    indices = np.asarray([3, 0, 4, 1, 2])
    labels = np.stack([np.full((12, 16), i, np.int32) for i in indices])
    ds = PseudoLabeledDataset(base, labels, indices)
    assert len(ds) == 5 and ds.shape_hw == (12, 16)
    assert ds.num_classes == CLASSES
    for i in range(5):
        img, lab = ds.load(i)
        assert lab.dtype == np.uint8 and (lab == i).all()
        np.testing.assert_array_equal(img, base.load(i)[0])


def _mixed_logits(seed, b=2, hw=(16, 20)):
    """Three bf16 source logits (11/19/5 classes) and one f32 3-class
    model's, channel-major, as numpy f32 holding the exact values."""
    rng = np.random.default_rng(seed)
    out = []
    for c, dtype in ((11, torch.bfloat16), (19, torch.bfloat16),
                     (5, torch.bfloat16), (CLASSES, torch.float32)):
        x = torch.from_numpy(rng.normal(0, 2, (b, c, *hw)).astype(
            np.float32)).to(dtype)
        out.append(x)
    convs = [label_conversion_matrix(n) for n, _ in SOURCES] + [
        np.concatenate([np.eye(CLASSES, dtype=np.float32),
                        np.zeros((CLASSES, 1), np.float32)], axis=1)]
    return out, convs


def _as_jax(x, channel_last=False):
    a = jnp.asarray(x.float().numpy())
    if channel_last:
        a = jnp.transpose(a, (0, 2, 3, 1))
    return a.astype(jnp.bfloat16 if x.dtype == torch.bfloat16
                    else jnp.float32)


@pytest.mark.parametrize("mode,conf_mode", [("soft", "prob"),
                                            ("soft", "entropy"),
                                            ("hard", "prob"),
                                            ("hard", "entropy")])
def test_mixed_dtype_ensemble_matches_jax_kernels(mode, conf_mode):
    """A round-1 ensemble (three bf16 sources and the f32 target model)
    through the plain versions of the channel-major pass and the
    pixel-major pass, each model read in its own dtype, against the JAX
    kernels (interpret mode) on the same list: confidences within 1e-5,
    labels equal."""
    logits, convs = _mixed_logits(seed=1 if mode == "soft" else 2)
    kc = np.asarray([0.3, 0.4, 0.5], np.float32)
    want_l, want_c = jax_pseudo_cm([_as_jax(x) for x in logits], convs,
                                   jnp.asarray(kc), mode=mode,
                                   conf_mode=conf_mode)
    got_l, got_c = fused_pseudo_cm_plain(logits, convs, torch.from_numpy(kc),
                                         mode=mode, conf_mode=conf_mode)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))

    nhwc = [x.permute(0, 2, 3, 1).contiguous() for x in logits]
    want_l, want_c = fused_pseudo_pass_pallas(
        [_as_jax(x, channel_last=True) for x in logits], convs, mode=mode,
        kc=jnp.asarray(kc), conf_mode=conf_mode)
    got_l, got_c = fused_pseudo_pass_plain(nhwc, convs, mode=mode,
                                           kc=torch.from_numpy(kc),
                                           conf_mode=conf_mode)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


class _Recording(port_gen.PseudoLabelGenerator):
    """A generator that keeps, at each sweep, a copy of every member's
    weights and the module it ran."""
    made = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.sweeps = []
        _Recording.made.append(self)

    def __call__(self, loader, return_device=False):
        self.sweeps.append([(s.model, {k: v.clone() for k, v in
                                       s.model.state_dict().items()})
                            for s in self.sources])
        return super().__call__(loader, return_device)


def test_target_member_is_its_own_module(monkeypatch):
    """Three port rounds on the CPU: the target member joins in round 1 as
    a module of its own (not the one being trained), and round 2 refreshes
    it with the weights the model had after round 1's fine-tune."""
    sources = [port_gen.make_source(
        n, ESPNetv2Segmentation(c, s=0.5, dec_base_planes=8), v, n,
        channel_major=True, device="cpu") for n, c, _, v in _source_trees()]
    model = ESPNetv2Segmentation(CLASSES, s=0.5, dec_base_planes=8)
    after_round = []
    real_train = port_st.train_segmentation

    def train(model, *a, **k):
        res = real_train(model, *a, **k)
        after_round.append({k2: v.clone()
                            for k2, v in model.state_dict().items()})
        return res

    _Recording.made = []
    monkeypatch.setattr(port_st, "PseudoLabelGenerator", _Recording)
    monkeypatch.setattr(port_st, "train_segmentation", train)
    monkeypatch.setattr(port_st, "TrainLoopConfig",
                        _no_augment(port_train.TrainLoopConfig))
    res = self_training(model, None, sources,
                        _target_sets(SyntheticSegmentation), None, CLASSES,
                        SelfTrainConfig(**{**ROUND_KW, "rounds": 3}),
                        device="cpu")
    assert [h["n_sources"] for h in res["history"]] == [3, 4, 4]
    plain, with_target = _Recording.made
    assert len(plain.sweeps) == 1 and len(with_target.sweeps) == 2
    for r, sweep in enumerate(with_target.sweeps, start=1):
        tgt_module, tgt_state = sweep[-1]
        assert tgt_module is not model
        for k, v in after_round[r - 1].items():
            assert torch.equal(tgt_state[k], v), (r, k)
    # the weights did move between the two sweeps
    assert any(not torch.equal(after_round[0][k], after_round[1][k])
               for k in after_round[0])


def test_self_training_raises_for_later_slices():
    """The mesh was a later slice and raised here (the test keeps its
    name); it is in now.  A mesh of one rank, without torch.distributed,
    runs a round bit for bit as `mesh=None` does: its collectives are the
    identity.  Meshes of several ranks: tests/test_torch_mesh.py."""
    def run(mesh):
        sources = [port_gen.make_source(
            n, ESPNetv2Segmentation(c, s=0.5, dec_base_planes=8), v, n,
            channel_major=True, device="cpu")
            for n, c, _, v in _source_trees()]
        torch.manual_seed(0)
        model = ESPNetv2Segmentation(CLASSES, s=0.5, dec_base_planes=8)
        res = self_training(model, None, sources,
                            _target_sets(SyntheticSegmentation), None,
                            CLASSES, SelfTrainConfig(**{**ROUND_KW,
                                                        "rounds": 1}),
                            mesh=mesh, device="cpu")
        return res["history"], res["variables"]

    (h_mesh, v_mesh), (h_none, v_none) = run(make_mesh()), run(None)
    assert make_mesh().shape == {"model": 1, "data": 1}
    assert h_mesh == h_none
    for k, v in v_none.items():
        assert torch.equal(v_mesh[k], v), k
