"""The PyTorch port's DeepLabV3 against the flax model on the CPU: one
perturbed flax variable tree of a small DeepLab (one bottleneck a stage,
a 32-wide ASPP, 4 classes) loaded through `load_flax_variables`, eval and
train-mode logits and BatchNorm statistics compared at fp32 (batch 2, and
batch 1, where the ASPP image pool normalizes one value per channel), the
bf16 mode, the torch twin's state-dict layout, an RGB-D tree, the model
factory and flax's initializers, and train-mode BatchNorm at one value per
channel against flax's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import BatchNorm as FlaxBatchNorm

from mspl_tpu.models import DeepLabV3 as FlaxDeepLab
from mspl_tpu.models.factory import init_model as jax_init_model
from mspl_tpu.oracle.torch_deeplab import TDeepLabV3
from mspl_tpu_torch.layers.conv_blocks import BatchNorm
from mspl_tpu_torch.models import (DeepLabV3, ESPNetv2Segmentation,
                                   build_segmentation_model, init_model)
from mspl_tpu_torch.models.deeplab import _Conv
from mspl_tpu_torch.utils.flax_bridge import load_flax_variables
from mspl_tpu_torch.utils.registry import MODEL_NAMES
from tests.test_torch_model import _plain_dicts, flax_variables

HW = (64, 64)
CLASSES = 4
MODEL_KW = dict(stage_blocks=(1, 1, 1, 1), aspp_features=32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1,
                                                                  2))))


def _images(batch, channels=3, seed=3):
    return np.random.default_rng(seed).normal(
        0, 1, (batch, *HW, channels)).astype(np.float32)


def _port(variables, **kw):
    port = DeepLabV3(CLASSES, **MODEL_KW, **kw)
    load_flax_variables(port, variables)
    return port


@pytest.fixture(scope="module")
def case():
    model = FlaxDeepLab(num_classes=CLASSES, **MODEL_KW)
    variables = flax_variables(model, HW, seed=5)
    x = _images(2)
    want = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    train = jax.jit(lambda v, a: model.apply(v, a, train=True,
                                             mutable=["batch_stats"]))
    trained = {}
    for b in (2, 1):
        out, mutated = train(variables, jnp.asarray(x[:b]))
        trained[b] = (np.asarray(out), _plain_dicts(jax.tree_util.tree_map(
            np.array, mutated["batch_stats"])))
    return dict(model=model, variables=variables, x=x,
                want=np.transpose(want, (0, 3, 1, 2)), trained=trained)


def test_load_flax_variables_fills_every_tensor(case):
    """Every parameter and statistic is written (NaN-filled first), and the
    port holds as many numbers as the flax tree."""
    port = DeepLabV3(CLASSES, **MODEL_KW)
    with torch.no_grad():
        for t in list(port.parameters()) + list(port.buffers()):
            if t.is_floating_point():
                t.fill_(float("nan"))
    load_flax_variables(port, case["variables"])
    for name, t in list(port.named_parameters()) + list(port.named_buffers()):
        if t.is_floating_point():
            assert torch.isfinite(t).all(), f"{name} was not loaded"
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(case["variables"]))
    n_port = sum(t.numel() for t in list(port.parameters()) + [
        b for n, b in port.named_buffers() if n.endswith(("_mean", "_var"))])
    assert n_flax == n_port
    assert not port.training


def test_eval_logits_match_flax(case):
    """fp32 eval logits (|logits| up to ~14) within 1e-4 (measured 1.7e-5),
    the same argmax."""
    port = _port(case["variables"])
    with torch.no_grad():
        got = port(_nchw(case["x"])).numpy()
    want = case["want"]
    assert got.shape == want.shape == (2, CLASSES, *HW)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(1) == want.argmax(1)).all()


def _bn_stats(port):
    return {n: b.clone() for n, b in port.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("batch", [2, 1])
def test_train_forward_and_statistics_match_flax(case, batch):
    """Train-mode logits within 1e-4 (measured 3.8e-5 and 3.3e-5 at
    |logits| up to ~3.5) and every updated running statistic
    within 1e-5 (means absolute, variances relative) of flax's
    `mutable=["batch_stats"]`; at batch 1 the ASPP image pool's BatchNorm
    sees one value per channel: its output is its bias and its running
    variance decays toward 0, as in flax."""
    port = _port(case["variables"]).train()
    with torch.no_grad():
        got = port(_nchw(case["x"][:batch])).numpy()
    want, stats = case["trained"][batch]
    np.testing.assert_allclose(got, np.transpose(want, (0, 3, 1, 2)),
                               rtol=0, atol=1e-4)
    ref = _port({"params": case["variables"]["params"],
                 "batch_stats": stats})
    want_b = _bn_stats(ref)
    for name, t in _bn_stats(port).items():
        if name.endswith("running_mean"):
            np.testing.assert_allclose(t.numpy(), want_b[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(t.numpy(), want_b[name].numpy(),
                                       rtol=1e-5, atol=0, err_msg=name)
    gp_var = port.aspp.gp_bn.running_var
    before = torch.from_numpy(
        case["variables"]["batch_stats"]["aspp"]["_BN_4"]["BatchNorm_0"][
            "var"])
    if batch == 1:
        torch.testing.assert_close(gp_var, 0.9 * before, rtol=1e-6, atol=0)
    else:
        assert not torch.allclose(gp_var, 0.9 * before)


def test_bf16_keeps_f32_params_and_emits_f32_logits(case):
    """bf16 compute: f32 parameters and logits (the classifier and the
    final resize run in f32, as flax promotes them), finite, within 5% of
    the fp32 logits' largest magnitude (measured 1.6%)."""
    port = _port(case["variables"], compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    with torch.no_grad():
        got = port(_nchw(case["x"]))
    assert got.dtype == torch.float32 and got.shape == (2, CLASSES, *HW)
    assert torch.isfinite(got).all()
    want = case["want"]
    assert np.abs(got.numpy() - want).max() <= 0.05 * np.abs(want).max()


def test_state_dict_has_the_torch_twins_layout():
    """Keys and shapes equal the torch twin's (`TDeepLabV3`), so a state
    dict of the reference torch layout loads with `load_state_dict`."""
    for kw in (MODEL_KW, {}):
        got = {k: tuple(v.shape) for k, v in
               DeepLabV3(CLASSES, **kw).state_dict().items()}
        want = {k: tuple(v.shape) for k, v in
                TDeepLabV3(CLASSES, **kw).state_dict().items()}
        assert got == want
    twin = TDeepLabV3(CLASSES, **MODEL_KW)
    port = DeepLabV3(CLASSES, **MODEL_KW)
    port.load_state_dict(twin.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k


def test_rgbd_tree_loads_into_four_channels():
    """A 4-channel flax tree loads into `in_channels=4` and gives flax's
    eval logits (within 1e-4); into a 3-channel model it raises on the
    stem's shape."""
    model = FlaxDeepLab(num_classes=CLASSES, **MODEL_KW)
    variables = flax_variables(model, HW, seed=6, channels=4)
    x = _images(1, channels=4, seed=4)
    want = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    port = _port(variables, in_channels=4)
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.transpose(want, (0, 3, 1, 2)),
                               rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="encoder.stem"):
        _port(variables)


def test_factory_builds_by_registry_name():
    """Both registry names build their model on the CPU (the third,
    segformer, is `tests/test_torch_segformer.py`'s); another name raises
    ValueError listing the registry's."""
    assert MODEL_NAMES == ("espnetv2", "deeplabv3", "segformer")
    esp = build_segmentation_model("espnetv2", 5, s=0.5, dec_base_planes=8)
    dl = build_segmentation_model("deeplabv3", 5, compute_dtype=torch.bfloat16,
                                  **MODEL_KW)
    assert isinstance(esp, ESPNetv2Segmentation)
    assert isinstance(dl, DeepLabV3) and dl.compute_dtype == torch.bfloat16
    assert next(dl.parameters()).device.type == "cpu"
    with pytest.raises(ValueError, match="deeplabv3"):
        build_segmentation_model("resnet", 5)
    with pytest.raises(TypeError):
        init_model(torch.nn.Linear(2, 2), torch.Generator().manual_seed(0))


def _scaled(w, scale):
    """A kernel in units of its variance scaling's std, sqrt(scale / fan_in)
    (OIHW or flax's HWIO, given as (fan_in, values))."""
    fan_in, values = w
    return np.asarray(values, np.float64).ravel() / np.sqrt(scale / fan_in)


def test_init_model_draws_flax_initializers():
    """DeepLab: every He-normal conv's and the lecun-normal classifier's
    std within 10% of flax's `init_model` on the same shapes (pooled over a
    kind of kernel, each kernel of 2048 or more values alone too), both cut
    at 2 of the untruncated law's std; zero classifier bias; BatchNorm at
    identity.  ESPNetv2 keeps `init_random`'s weights."""
    kw = dict(stage_blocks=(1, 1, 1, 1), aspp_features=64)
    port = init_model(DeepLabV3(19, **kw), torch.Generator().manual_seed(0))
    flax = jax_init_model(FlaxDeepLab(num_classes=19, **kw), HW,
                          jax.random.PRNGKey(0))
    want = {"he": [], "lecun": []}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            flax["params"])[0]:
        if path[-1].key == "kernel":
            kind = "lecun" if path[-2].key == "classifier" else "he"
            want[kind].append((int(np.prod(leaf.shape[:-1])), leaf))
    got = {"he": [], "lecun": []}
    for mod in port.modules():
        if isinstance(mod, _Conv):
            got["he"].append((mod.weight[0].numel(), mod.weight.detach()))
    got["lecun"].append((port.classifier.weight[0].numel(),
                         port.classifier.weight.detach()))
    assert len(got["he"]) == len(want["he"])
    for kind, scale in (("he", 2.0), ("lecun", 1.0)):
        g = np.concatenate([_scaled(w, scale) for w in got[kind]])
        f = np.concatenate([_scaled(w, scale) for w in want[kind]])
        assert abs(g.std() / f.std() - 1) <= 0.1, kind
        assert np.abs(g).max() <= 2 / 0.87962566103423978 + 1e-5
        assert np.abs(f).max() <= 2 / 0.87962566103423978 + 1e-5
    big = [(_scaled(a, 2.0).std(), _scaled(b, 2.0).std()) for a, b in zip(
        sorted(got["he"], key=lambda w: w[1].numel()),
        sorted(want["he"], key=lambda w: w[1].size)) if a[1].numel() >= 2048]
    assert len(big) >= 10
    for g, f in big:
        assert abs(g / f - 1) <= 0.1
    assert torch.equal(port.classifier.bias, torch.zeros(19))
    for mod in port.modules():
        if isinstance(mod, BatchNorm):
            assert (mod.weight == 1).all() and (mod.bias == 0).all()
            assert (mod.running_mean == 0).all()
            assert (mod.running_var == 1).all()
    esp = init_model(ESPNetv2Segmentation(5, s=0.5, dec_base_planes=8),
                     torch.Generator().manual_seed(1))
    assert (esp.base_net.level1.act.alpha == 0.25).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batchnorm_at_one_value_per_channel_matches_flax(dtype):
    """A [1, C, 1, 1] input in train mode, where torch's batch norm raises:
    the output is the bias (in x's dtype), the running mean takes the value
    and the running variance 0 (0.9 * var), as flax's BatchNorm gives
    (within 1e-6); the gradients are flax's: 0 to x and the scale, the
    upstream gradient to the bias."""
    rng = np.random.default_rng(1)
    c = 5
    x = rng.normal(0.5, 2.0, (1, 1, 1, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    g = rng.normal(0, 1, (1, 1, 1, c)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    bn = FlaxBatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jdt)
    stats0 = {"mean": mean0, "var": var0}

    def fwd(params, xj):
        out, mutated = bn.apply({"params": params, "batch_stats": stats0},
                                xj, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * g), (out, mutated)

    xj = jnp.asarray(x).astype(jdt)
    (_, (want, mutated)), (gp, gx) = jax.value_and_grad(
        fwd, argnums=(0, 1), has_aux=True)(
            {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, xj)
    port = BatchNorm(c).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(tdt).requires_grad_()
    got = port(xt)
    assert got.dtype == tdt and got.shape == (1, c, 1, 1)
    (got.float() * _nchw(g)).sum().backward()
    want = _nchw(np.asarray(want.astype(jnp.float32)))
    torch.testing.assert_close(got.detach().float(), want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got.detach().float().flatten(),
                               torch.from_numpy(bias).to(tdt).float())
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(port.running_var.numpy(), 0.9 * var0,
                               rtol=1e-6)
    assert (xt.grad == 0).all() and (port.weight.grad == 0).all()
    assert float(np.abs(np.asarray(gx, np.float32)).max()) == 0.0
    np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(gp["bias"]),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gp["scale"]), 0.0, atol=0)
