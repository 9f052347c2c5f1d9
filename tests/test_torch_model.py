"""The PyTorch port's ESPNetv2 against the flax model: one perturbed flax
variable tree loaded through `load_flax_variables`, eval logits compared at
fp32 (channel-major, as the pseudo-label main path emits them), plus the
resampling and normalization ops the model and the engine are built from."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data.transforms import normalize as jax_normalize
from mspl_tpu.layers.eesp import _avg_pool_3x3_s2 as jax_avg_pool
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu.ops.resize import adaptive_avg_pool as jax_adaptive_avg_pool
from mspl_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from mspl_tpu_torch.data.transforms import normalize
from mspl_tpu_torch.layers.eesp import _avg_pool_3x3_s2
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.ops.resize import adaptive_avg_pool, resize_bilinear
from mspl_tpu_torch.utils.flax_bridge import load_flax_variables

HW = (64, 96)


def flax_variables(model, hw, seed, channels=3):
    """A perturbed variable tree for `model`, made with numpy from `seed`
    on the shapes of `model.init` for a `channels`-channel image (no
    compiled init): He-normal kernels, BN scales/shifts/means away from
    identity, variances in [0.5, 1.5], PReLU alphas in [0, 0.5].  Returned
    as nested dicts of numpy arrays."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, hw[0], hw[1], channels), jnp.float32), train=False))

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), s.shape)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape)
        if name == "alpha":
            return rng.uniform(0.0, 0.5, s.shape)
        return rng.normal(0.0, 0.1, s.shape)  # BN shift/mean, conv bias

    return _plain_dicts(jax.tree_util.tree_map_with_path(
        lambda p, s: fill(p, s).astype(np.float32), shapes))


def _plain_dicts(tree):
    if hasattr(tree, "items"):
        return {k: _plain_dicts(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def case():
    model = FlaxESPNetv2(num_classes=11, s=0.5, dec_base_planes=8,
                         channel_major_logits=True)
    variables = flax_variables(model, HW, seed=1)
    x = np.random.default_rng(3).normal(0, 1, (2, *HW, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    return variables, x, want


def test_load_flax_variables_fills_every_tensor(case):
    variables, _, _ = case
    port = ESPNetv2Segmentation(11, s=0.5, dec_base_planes=8)
    with torch.no_grad():
        for t in list(port.parameters()) + list(port.buffers()):
            if t.is_floating_point():
                t.fill_(float("nan"))
    load_flax_variables(port, variables)
    for name, t in list(port.named_parameters()) + list(port.named_buffers()):
        if t.is_floating_point():
            assert torch.isfinite(t).all(), f"{name} was not loaded"
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(variables))
    n_port = sum(t.numel() for t in list(port.parameters()) + [
        b for n, b in port.named_buffers() if n.endswith(("_mean", "_var"))])
    assert n_flax == n_port
    assert not port.training


def test_eval_logits_match_flax(case):
    variables, x, want = case
    port = ESPNetv2Segmentation(11, s=0.5, dec_base_planes=8,
                                channel_major_logits=True)
    load_flax_variables(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 11, *HW)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_bf16_compute_keeps_f32_params_and_emits_bf16(case):
    variables, x, want = case
    port = ESPNetv2Segmentation(11, s=0.5, dec_base_planes=8,
                                compute_dtype=torch.bfloat16)
    load_flax_variables(port, variables)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 11, *HW)
    assert torch.isfinite(got.float()).all()


def test_train_forward_raises():
    """Train runs on the native encoder route; the `use_pallas` route's
    branch kernel is eval only (its TPU kernel has no VJP)."""
    port = ESPNetv2Segmentation(5, s=0.5, dec_base_planes=8,
                                use_pallas=True).train()
    with pytest.raises(NotImplementedError, match="eval-only"):
        port(torch.zeros(1, 3, 32, 48))


@pytest.mark.parametrize("size,align", [((24, 36), True), ((7, 5), True),
                                        ((13, 29), False), ((16, 20), True)])
def test_resize_bilinear_matches_jax(size, align):
    x = np.random.default_rng(5).normal(0, 1, (2, 16, 20, 3)).astype(np.float32)
    want = np.asarray(jax_resize_bilinear(jnp.asarray(x), size,
                                          align_corners=align))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size,
                          align_corners=align)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [(8, 10), (5, 5), (3, 7)])
def test_adaptive_avg_pool_matches_jax(size):
    x = np.random.default_rng(6).normal(0, 1, (2, 16, 20, 4)).astype(np.float32)
    want = np.asarray(jax_adaptive_avg_pool(jnp.asarray(x), size))
    got = adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(16, 20), (15, 9)])
def test_avg_pool_3x3_s2_counts_padding_like_jax(hw):
    x = np.random.default_rng(7).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_avg_pool(jnp.asarray(x)))
    got = _avg_pool_3x3_s2(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("channels", [3, 4])
def test_normalize_matches_jax(channels):
    img = np.random.default_rng(8).integers(0, 256, (2, 6, 10, channels),
                                            dtype=np.uint8)
    want = np.asarray(jax_normalize(jnp.asarray(img)))
    got = normalize(torch.from_numpy(img))
    assert got.shape == (2, channels, 6, 10) and got.is_contiguous()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)
