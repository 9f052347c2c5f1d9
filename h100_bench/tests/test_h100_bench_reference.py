"""The plain reference against the port's plain path (its CPU fallbacks) at
tiny sizes, on the same seeded weights: the ESPNetv2 and DeepLab forwards
in eval and train, the fusion and CBST, the augmentation and one SGD step.
This test may import both; the reference itself imports nothing of the
port."""

import numpy as np
import pytest
import torch

from h100_bench import common
from h100_bench.reference import pipeline as ref
from h100_bench.tests import tiny
from h100_bench.weights import make_state, shapes_of

ESP = tiny.ESP["model"]
DL = tiny.DEEPLAB["model"]
CPU = torch.device("cpu")


def _pair(spec, classes, dtype, seed=7):
    from h100_bench import program
    with torch.device("meta"):
        shapes = shapes_of(ref.build_model(spec, classes, dtype))
    state = make_state(spec["name"], shapes, seed, CPU)
    port = program.model(spec, classes, dtype, CPU)
    port.load_state_dict(state)
    mine = ref.build_model(spec, classes, dtype)
    mine.load_state_dict(state)
    return port, mine


def _images(n=2, seed=3):
    return torch.from_numpy(common.uint8_images(seed, n, tiny.HW, CPU))


@pytest.mark.parametrize("spec,dtype,tol", [
    (ESP, torch.float32, 1e-4), (ESP, torch.bfloat16, 0.0),
    (DL, torch.float32, 1e-4)])
def test_eval_forward(spec, dtype, tol):
    port, mine = _pair(spec, 11, dtype)
    x = ref.normalize(_images())
    with torch.no_grad():
        a = port.eval()(x).float()
        b = mine.eval()(x).float()
    assert a.shape == b.shape == (2, 11, *tiny.HW)
    assert (a - b).abs().max() <= tol * b.abs().max()


@pytest.mark.parametrize("spec", [ESP, DL])
def test_train_forward_and_gradients(spec):
    port, mine = _pair(spec, 3, torch.float32)
    x = ref.normalize(_images(4))
    outs = []
    for m in (port, mine):
        m.train()
        y = m(x)
        (y.float() ** 2).mean().backward()
        outs.append((y.detach(), {n: p.grad for n, p in
                                  m.named_parameters()}))
    (ya, ga), (yb, gb) = outs
    assert torch.allclose(ya, yb, rtol=1e-4, atol=1e-4 * yb.abs().max())
    assert ga.keys() == gb.keys()
    for n in ga:
        scale = gb[n].abs().max() + 1e-12
        assert (ga[n] - gb[n]).abs().max() <= 1e-3 * scale, n


def test_fusion_and_cbst():
    from mspl_tpu_torch.data.label_space import label_conversion_matrix
    from mspl_tpu_torch.ops.pseudo_cm import fused_pseudo_cm_plain
    from mspl_tpu_torch.pseudo import cbst

    g = torch.Generator().manual_seed(0)
    names, classes = ("camvid", "cityscapes", "forest"), (11, 19, 5)
    logits = [torch.randn(2, c, 8, 12, generator=g) * 3 for c in classes]
    kc = np.array([0.4, 0.5, 0.6], np.float32)
    lab_p, conf_p = fused_pseudo_cm_plain(
        logits, [label_conversion_matrix(n) for n in names],
        torch.as_tensor(kc))
    lab_r, conf_r, _ = ref.soft_fusion(
        logits, [ref.conversion(n) for n in names], kc)
    assert torch.equal(lab_p.long(), lab_r)
    assert torch.allclose(conf_p, conf_r, atol=1e-6)
    hist_p = cbst.class_confidence_histograms(lab_p, conf_p, 3)
    hist_r = ref.histograms(lab_r, conf_r, 3)
    assert torch.equal(hist_p.double(), hist_r)
    for p in (0.2, 0.5, 1.0):
        assert np.array_equal(cbst.kc_from_histograms(hist_p, p),
                              ref.kc_from_histograms(hist_r, p))
    assert torch.equal(
        cbst.apply_kc_device(lab_p, conf_p, kc).long(),
        ref.apply_kc(lab_r, conf_r, kc))


def test_augmentation_draws_and_crop():
    from mspl_tpu_torch.data.transforms import train_transform
    from mspl_tpu_torch.engine.train import step_generator

    imgs = _images(3)
    labels = torch.randint(0, 3, (3, *tiny.HW), dtype=torch.int64)
    crop, scales = (24, 40), (0.7, 1.3)
    a, la = train_transform(imgs, labels, crop, step_generator(11, 2),
                            scales)
    draws = ref.step_draws(11, 2, 3, tiny.HW, crop, scales)
    b, lb = ref.scale_crop_flip(ref.normalize(imgs), labels, crop, *draws)
    assert torch.allclose(a, b, atol=1e-5)
    assert torch.equal(la, lb)


@pytest.mark.parametrize("spec", [ESP, DL])
def test_one_sgd_step(spec):
    from mspl_tpu_torch.engine.losses import compute_class_weights
    from mspl_tpu_torch.engine.schedules import build_schedule
    from mspl_tpu_torch.engine.train import (create_train_state,
                                             make_train_step)

    port, mine = _pair(spec, 3, torch.float32)
    imgs = _images(2)
    labels = torch.randint(0, 3, (2, *tiny.HW), dtype=torch.int64)
    labels[:, ::2] = ref.IGNORE
    hist = np.bincount(labels[labels != 255].numpy(), minlength=3)
    cw = compute_class_weights(hist)
    state = create_train_state(port, "sgd", build_schedule("poly", 1e-3, 10),
                               0.9, 4e-5, device="cpu")
    step = make_train_step(port, (32, 48), (0.7, 1.3), cw, "kld", 0.1,
                           device="cpu")
    init = {n: p.detach().clone() for n, p in mine.named_parameters()}
    _, out = step(state, {"image": imgs.numpy(), "label": labels.numpy()},
                  torch.Generator().manual_seed(0 * 2 ** 32 + 0))
    mine.train()
    draws = ref.step_draws(0, 0, 2, tiny.HW, (32, 48), (0.7, 1.3))
    x, lab = ref.scale_crop_flip(ref.normalize(imgs), labels, (32, 48),
                                 *draws)
    params = [p for _, p in mine.named_parameters()]
    loss = ref.loss_fn(mine(x), lab, torch.as_tensor(
        ref.class_weights(hist)), 0.1)
    grads = torch.autograd.grad(loss, params)
    ref.sgd_step(params, grads, [None] * len(params),
                 ref.poly_lr(1e-3, 10, 0), 0.9, 4e-5)
    assert float(out["loss"]) == pytest.approx(loss.item(), rel=1e-5)
    for (n, p), (_, q) in zip(port.named_parameters(),
                              mine.named_parameters()):
        d_ref = (q - init[n]).norm()
        assert (p - q).norm() <= 1e-3 * d_ref + 1e-9, n


@pytest.mark.parametrize("spec", [ESP, DL])
def test_every_model_key_reaches_both_sides(spec):
    """A key of the configuration's model entry that a side does not take
    raises there; the route reaches the port alone."""
    from h100_bench import program
    bad = dict(spec, no_such_key=1)
    with pytest.raises(TypeError):
        program.model(bad, 3, torch.float32, CPU)
    with pytest.raises(TypeError):
        ref.build_model(bad, 3, torch.float32)
    with pytest.raises(TypeError):
        program.model(spec, 3, torch.float32, CPU, {"no_such_route": 1})


@pytest.mark.parametrize("spec,dtype", [
    (ESP, torch.float32), (ESP, torch.bfloat16), (DL, torch.float32)])
def test_calibrated_statistics_are_the_batch_statistics(spec, dtype):
    """After `calibrated` over x, the eval forward on x is the train forward
    on x, and the logits are of a trained model's size."""
    from h100_bench.weights import calibrated
    _, mine = _pair(spec, 11, dtype)
    x = ref.normalize(_images(4)).to(dtype)
    mine.load_state_dict(calibrated(mine, x))
    with torch.no_grad():
        a = mine.eval()(x).float()
        b = mine.train()(x).float()
    tol = 1e-4 if dtype == torch.float32 else 0.05
    assert (a - b).abs().max() <= tol * b.abs().max()
    assert a.abs().max() < 100
