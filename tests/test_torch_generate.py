"""The PyTorch port's pseudo-label slice against the JAX package, on the CPU.

Three tiny ESPNetv2 sources (CamVid 11, Cityscapes 19, Forest 5 classes)
share one perturbed flax variable tree each between the two packages; the
same uint8 batches go through each package's DataLoader and
PseudoLabelGenerator on channel-major sources (soft fusion, prob
confidence, kc), then through the CBST histograms and kc."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data.label_space import label_conversion_matrix
from mspl_tpu.data.loader import DataLoader as JaxDataLoader
from mspl_tpu.data.transforms import normalize as jax_normalize
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu.pseudo import cbst as jax_cbst
from mspl_tpu.pseudo import generate as jax_gen
from mspl_tpu_torch.data.loader import DataLoader
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.ops.pseudo_cm import fused_pseudo_cm
from mspl_tpu_torch.pseudo import cbst
from mspl_tpu_torch.pseudo.generate import (PseudoLabelGenerator,
                                            fused_pseudo_pass,
                                            generate_pseudo_labels,
                                            make_source)

from tests.test_torch_model import flax_variables

HW = (32, 48)
SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))
KC = np.asarray([0.45, 0.5, 0.55], np.float32)
N_IMAGES, BATCH = 6, 4  # two batches, the tail one padded


class _Images:
    """In-memory target set: uint8 images, labels unused (all ignore)."""

    def __init__(self, seed):
        self.images = np.random.default_rng(seed).integers(
            0, 256, (N_IMAGES, *HW, 3), dtype=np.uint8)

    def __len__(self):
        return N_IMAGES

    def load(self, i):
        return self.images[i], np.full(HW, 255, np.int32)


def _variables(model, seed):
    v = flax_variables(model, HW, seed)
    # widen the last classifier: at this size the logits otherwise vary by
    # ~0.07 across the image and every pixel gets nearly the same fused
    # distribution; x20 spreads the confidences over (0, 1)
    v["params"]["bu_dec_l4"]["classify"]["Conv_0"]["kernel"] *= 20.0
    return v


def _port_sources(variables, channel_major=True):
    return [make_source(name, ESPNetv2Segmentation(c, s=0.5, dec_base_planes=8),
                        v, name, channel_major=channel_major, device="cpu")
            for (name, c), v in zip(SOURCES, variables)]


@pytest.fixture(scope="module")
def sweep():
    models = [FlaxESPNetv2(num_classes=c, s=0.5, dec_base_planes=8)
              for _, c in SOURCES]
    variables = [_variables(m, seed=10 + i) for i, m in enumerate(models)]
    data = _Images(seed=4)

    jsrcs = [jax_gen.make_source(name, m, v, name, channel_major=True)
             for (name, _), m, v in zip(SOURCES, models, variables)]
    j_gen = jax_gen.PseudoLabelGenerator(jsrcs, mode="soft", kc=KC)
    want = j_gen(JaxDataLoader(data, batch_size=BATCH, num_workers=1))

    # JAX's fused soft distribution, for the top-2 margin of every pixel
    def fused(imgs):
        x = jax_normalize(imgs)
        acc = 0.0
        for s in jsrcs:
            p = jax.nn.softmax(s.apply_fn(x).astype(jnp.float32), axis=1)
            acc = acc + jnp.einsum("bchw,ct->bthw", p,
                                   jnp.asarray(s.conversion))
        return acc / len(jsrcs)

    dist = np.asarray(jax.jit(fused)(jnp.asarray(data.images)))[:, :3]
    top2 = np.sort(dist, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]

    p_gen = PseudoLabelGenerator(_port_sources(variables), mode="soft", kc=KC,
                                 device="cpu")
    got = p_gen(DataLoader(data, batch_size=BATCH, num_workers=1))
    return dict(variables=variables, data=data, want=want, got=got,
                margin=margin, p_gen=p_gen)


def test_generator_matches_jax(sweep):
    (wl, wc, wi), (gl, gc, gi) = sweep["want"], sweep["got"]
    assert gl.dtype == np.int32 and gc.dtype == np.float32
    assert gl.shape == wl.shape == (N_IMAGES, *HW)
    np.testing.assert_array_equal(gi, wi)
    # confidences spread over (0, 1): the comparison is not of one-hots
    assert np.unique(np.round(wc, 3)).size > 50
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-4)
    thr = np.where(wl == 255, 0.0, KC[np.minimum(wl, 2)])
    decided = (sweep["margin"][wi] > 1e-4) & (np.abs(wc - thr) > 1e-4)
    assert decided.mean() > 0.99
    np.testing.assert_array_equal(gl[decided], wl[decided])
    assert set(np.unique(gl)) <= {0, 1, 2, 255}


def test_histograms_and_kc_match_jax(sweep):
    (wl, wc, _), (gl, gc, _) = sweep["want"], sweep["got"]
    # same inputs: the two histogram functions agree count for count
    want_h = np.asarray(jax_cbst.class_confidence_histograms(
        jnp.asarray(wl), jnp.asarray(wc), 3))
    got_h = cbst.class_confidence_histograms(torch.from_numpy(wl),
                                             torch.from_numpy(wc), 3)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    for p in (0.2, 0.5, 0.8, 1.0):
        np.testing.assert_array_equal(cbst.kc_from_histograms(got_h, p),
                                      jax_cbst.kc_from_histograms(want_h, p))
    # each package on its own sweep: counts move only for pixels whose
    # label differs or whose confidence lies within the 1e-4 confidence
    # tolerance of a bin edge, and kc by at most one bin
    own_h = cbst.class_confidence_histograms(torch.from_numpy(gl),
                                             torch.from_numpy(gc), 3)
    scaled = wc * cbst.DEFAULT_BINS
    near_edge = np.abs(scaled - np.round(scaled)) < 1e-4 * cbst.DEFAULT_BINS
    movable = int(((gl != wl) | near_edge).sum())
    assert np.abs(own_h.numpy() - want_h).sum() <= 2 * movable
    for p in (0.2, 0.5, 0.8):
        np.testing.assert_allclose(cbst.kc_from_histograms(own_h, p),
                                   jax_cbst.kc_from_histograms(want_h, p),
                                   rtol=0, atol=1.0 / cbst.DEFAULT_BINS)


def test_return_device_matches_host_path(sweep):
    labels, confs, idx = sweep["p_gen"](
        DataLoader(sweep["data"], batch_size=BATCH, num_workers=1),
        return_device=True)
    gl, gc, gi = sweep["got"]
    assert labels.dtype == torch.uint8 and isinstance(idx, np.ndarray)
    np.testing.assert_array_equal(labels.numpy().astype(np.int32), gl)
    np.testing.assert_array_equal(confs.numpy(), gc)
    np.testing.assert_array_equal(idx, gi)


def test_nhwc_sources_take_the_plain_pass(sweep):
    """channel_major=False sources hand NHWC logits to fused_pseudo_pass;
    with a kc array both fused passes threshold alike."""
    labels, confs, _ = generate_pseudo_labels(
        _port_sources(sweep["variables"], channel_major=False),
        DataLoader(sweep["data"], batch_size=BATCH, num_workers=1),
        mode="soft", kc=KC, device="cpu")
    gl, gc, _ = sweep["got"]
    np.testing.assert_allclose(confs, gc, rtol=0, atol=1e-5)
    assert (labels == gl).mean() > 0.999


def test_set_variables_swaps_weights_in_place(sweep):
    variables = sweep["variables"]
    swapped = [variables[0], variables[1],
               _variables(FlaxESPNetv2(num_classes=5, s=0.5,
                                       dec_base_planes=8), seed=99)]
    gen = PseudoLabelGenerator(_port_sources(variables), kc=KC, device="cpu")
    model = gen.sources[2].model
    gen.set_variables(2, swapped[2])
    assert gen.sources[2].model is model
    fresh = PseudoLabelGenerator(_port_sources(swapped), kc=KC, device="cpu")
    loader = lambda: DataLoader(sweep["data"], batch_size=BATCH,  # noqa: E731
                                num_workers=1)
    a, b = gen(loader()), fresh(loader())
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[1], sweep["got"][1])


@pytest.mark.parametrize("kwargs", [dict(mesh=object()),
                                    dict(conf_mode="margin"),
                                    dict(mode="vote")])
def test_generator_rejects_what_this_slice_lacks(sweep, kwargs):
    with pytest.raises((NotImplementedError, ValueError)):
        PseudoLabelGenerator(_port_sources(sweep["variables"]), device="cpu",
                             **kwargs)


@pytest.mark.parametrize("with_kc", [False, True])
@pytest.mark.parametrize("conf_mode", ["prob", "entropy"])
@pytest.mark.parametrize("mode,min_agree",
                         [("soft", None), ("hard", None), ("hard", 3)])
def test_fused_pseudo_pass_matches_jax(mode, min_agree, conf_mode, with_kc):
    rng = np.random.default_rng(21)
    logits = [rng.normal(0, 2, (2, 8, 12, c)).astype(np.float32)
              for _, c in SOURCES]
    convs = [label_conversion_matrix(n) for n, _ in SOURCES]
    kc = KC if with_kc else None
    wl, wc = jax_gen.fused_pseudo_pass(
        [jnp.asarray(x) for x in logits], convs, mode=mode, kc=kc,
        min_agree=min_agree, conf_mode=conf_mode)
    gl, gc = fused_pseudo_pass([torch.from_numpy(x) for x in logits], convs,
                               mode=mode, kc=kc, min_agree=min_agree,
                               conf_mode=conf_mode)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=0, atol=1e-5)
    if with_kc:  # with a kc array the channel-major pass gives the same
        cl, cc = fused_pseudo_cm(
            [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
             for x in logits], convs, torch.from_numpy(KC), mode=mode,
            min_agree=min_agree, conf_mode=conf_mode)
        np.testing.assert_array_equal(cl.numpy(), gl.numpy())
        np.testing.assert_allclose(cc.numpy(), gc.numpy(), rtol=0, atol=1e-5)
