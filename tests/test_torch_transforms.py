"""The port's train-time transforms against the JAX package on the CPU.

The JAX package draws (s, y0, x0, flip) from a PRNG key; the port draws
from a torch.Generator, so the two cannot agree on the draws themselves.
The tests take the reference's draws from a key exactly as
`mspl_tpu.data.transforms.random_scale_crop_flip` makes them (split into
four, uniform scale, uniform origins, bernoulli flip), feed them to the
port's deterministic core `scale_crop_flip`, and compare with the
reference's output at the same key: images within 1e-5, labels exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspl_tpu.data.transforms import normalize as jax_normalize
from mspl_tpu.data.transforms import random_scale_crop_flip as jax_rscf
from mspl_tpu.data.transforms import train_transform as jax_train_transform
import mspl_tpu_torch.data.transforms as port_transforms
from mspl_tpu_torch.data.transforms import (draw_scale_crop_flip, normalize,
                                            random_scale_crop_flip,
                                            scale_crop_flip, train_transform)

SCALE_RANGE = (0.5, 2.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's CPU ops on two threads for this module: the tests run in
    several workers on one host, where small ops on as many threads as
    cores mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_draws(key, in_hw, crop_hw, scale_range=SCALE_RANGE):
    """The reference's draws from `key` (transforms.py: split, uniform
    scale, window origins, bernoulli flip)."""
    k_scale, k_y, k_x, k_flip = jax.random.split(key, 4)
    s = jax.random.uniform(k_scale, (), minval=scale_range[0],
                           maxval=scale_range[1])
    y0 = jax.random.uniform(k_y, ()) * jnp.maximum(in_hw[0] - crop_hw[0] / s,
                                                   0.0)
    x0 = jax.random.uniform(k_x, ()) * jnp.maximum(in_hw[1] - crop_hw[1] / s,
                                                   0.0)
    flip = jax.random.bernoulli(k_flip, 0.5)
    return tuple(np.asarray(v) for v in (s, y0, x0, flip))


def _key_where(pred, in_hw, crop_hw):
    """The first PRNG key (by seed) whose draws satisfy `pred(s, flip)`."""
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        s, _, _, flip = jax_draws(key, in_hw, crop_hw)
        if pred(float(s), bool(flip)):
            return key
    raise AssertionError("no key gives such draws")


def _case(seed, hw, channels):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (1, *hw, channels), dtype=np.uint8)
    labels = rng.integers(0, 5, (1, *hw)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.1] = 255
    return imgs, labels


CASES = {
    # name: (image h x w, crop h x w, channels, which draws)
    "s<1-flip": ((32, 48), (32, 48), 3, lambda s, f: s < 1 and f),
    "s<1-noflip": ((32, 48), (32, 48), 3, lambda s, f: s < 1 and not f),
    "s>1-flip": ((32, 48), (32, 48), 3, lambda s, f: s > 1 and f),
    "s>1-noflip": ((32, 48), (32, 48), 3, lambda s, f: s > 1 and not f),
    "odd-size": ((37, 53), (29, 41), 3, lambda s, f: s > 1.2),
    "rgbd": ((32, 48), (24, 40), 4, lambda s, f: s < 0.8),
}


@pytest.mark.parametrize("name", list(CASES))
def test_scale_crop_flip_matches_jax_at_its_draws(name):
    """One image through the reference's `random_scale_crop_flip` at a key
    and through the port's core at that key's draws."""
    hw, crop, channels, pred = CASES[name]
    key = _key_where(pred, hw, crop)
    imgs, labels = _case(list(CASES).index(name), hw, channels)
    x = jax_normalize(jnp.asarray(imgs[0]))
    want_img, want_lab = jax_rscf(x, jnp.asarray(labels[0]), crop, key,
                                  SCALE_RANGE)
    s, y0, x0, flip = jax_draws(key, hw, crop)
    got_img, got_lab = scale_crop_flip(
        normalize(torch.from_numpy(imgs)), torch.from_numpy(labels), crop,
        *(torch.from_numpy(np.asarray([v])) for v in (s, y0, x0, flip)))
    assert got_img.shape == (1, channels, *crop)
    assert got_lab.shape == (1, *crop)
    np.testing.assert_allclose(got_img[0].permute(1, 2, 0).numpy(),
                               np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_lab[0].numpy(), np.asarray(want_lab))
    if s < 1:  # the window overhangs the image: zeros and ignore appear
        assert (got_lab == 255).float().mean() > (labels == 255).mean()


def test_train_transform_matches_jax_batched():
    """A batch of 4 through the reference's `train_transform` (normalize,
    one key per image from `split(key, B)`) and through the port's
    normalize and core at those keys' draws."""
    hw, crop = (32, 48), (28, 40)
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, (4, *hw, 3), dtype=np.uint8)
    labels = rng.integers(0, 5, (4, *hw)).astype(np.int32)
    key = jax.random.PRNGKey(42)
    want_img, want_lab = jax_train_transform(
        jnp.asarray(imgs), jnp.asarray(labels), crop, key, SCALE_RANGE)
    draws = [jax_draws(k, hw, crop) for k in jax.random.split(key, 4)]
    s, y0, x0, flip = (torch.from_numpy(np.stack([d[i] for d in draws]))
                       for i in range(4))
    got_img, got_lab = scale_crop_flip(normalize(torch.from_numpy(imgs)),
                                       torch.from_numpy(labels), crop, s, y0,
                                       x0, flip)
    np.testing.assert_allclose(got_img.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))


def test_draws_follow_the_reference_rule():
    """The port's own draws: s inside the range, the window inside the
    image where it fits (at 0 where it does not), about half flipped, and
    the same generator seed gives the same draws."""
    hw, crop = (64, 96), (48, 64)
    s, y0, x0, flip = draw_scale_crop_flip(
        4000, hw, crop, torch.Generator().manual_seed(3), SCALE_RANGE)
    assert float(s.min()) >= 0.5 and float(s.max()) < 2.0
    room_y = (hw[0] - crop[0] / s).clamp_min(0)
    room_x = (hw[1] - crop[1] / s).clamp_min(0)
    assert bool(((y0 >= 0) & (y0 <= room_y)).all())
    assert bool(((x0 >= 0) & (x0 <= room_x)).all())
    assert bool((y0[room_y == 0] == 0).all())
    assert 0.45 < flip.float().mean().item() < 0.55
    again = draw_scale_crop_flip(4000, hw, crop,
                                 torch.Generator().manual_seed(3),
                                 SCALE_RANGE)
    for a, b in zip((s, y0, x0, flip), again):
        assert torch.equal(a, b)


def test_train_transform_is_the_core_at_its_draws():
    """`train_transform` from a generator equals normalize + the core at
    the draws the same generator state gives."""
    hw, crop = (32, 48), (32, 48)
    rng = np.random.default_rng(8)
    imgs = torch.from_numpy(rng.integers(0, 256, (3, *hw, 3),
                                         dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 5, (3, *hw)).astype(np.int32))
    got = train_transform(imgs, labels, crop,
                          torch.Generator().manual_seed(9), (0.7, 1.3))
    draws = draw_scale_crop_flip(3, hw, crop,
                                 torch.Generator().manual_seed(9), (0.7, 1.3))
    want = scale_crop_flip(normalize(imgs), labels, crop, *draws)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == torch.float32 and got[1].dtype == labels.dtype


@pytest.mark.parametrize("name", list(CASES))
def test_random_scale_crop_flip_matches_jax_at_its_key(name, monkeypatch):
    """The per-image function against the reference's at a key: the port's
    draw, patched to return that key's draws, then its core on a batch of
    one; a [C, H, W] image and an [H, W] label in, one crop out."""
    hw, crop, channels, pred = CASES[name]
    key = _key_where(pred, hw, crop)
    imgs, labels = _case(10 + list(CASES).index(name), hw, channels)
    x = jax_normalize(jnp.asarray(imgs[0]))
    want_img, want_lab = jax_rscf(x, jnp.asarray(labels[0]), crop, key,
                                  SCALE_RANGE, ignore_label=250)
    draws = jax_draws(key, hw, crop)

    def key_draws(n, in_hw, crop_hw, generator, scale_range):
        assert (n, in_hw, crop_hw, scale_range) == (1, hw, crop,
                                                    SCALE_RANGE)
        return tuple(torch.from_numpy(np.asarray([v])) for v in draws)

    monkeypatch.setattr(port_transforms, "draw_scale_crop_flip", key_draws)
    got_img, got_lab = random_scale_crop_flip(
        normalize(torch.from_numpy(imgs))[0], torch.from_numpy(labels[0]),
        crop, torch.Generator(), SCALE_RANGE, ignore_label=250)
    assert got_img.shape == (channels, *crop) and got_lab.shape == crop
    np.testing.assert_allclose(got_img.permute(1, 2, 0).numpy(),
                               np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))


def test_random_scale_crop_flip_is_the_core_at_its_draws():
    """From a generator: the core at the draws the same generator state
    gives, the label dtype kept."""
    hw, crop = (32, 48), (24, 40)
    rng = np.random.default_rng(14)
    img = normalize(torch.from_numpy(rng.integers(0, 256, (1, *hw, 3),
                                                  dtype=np.uint8)))[0]
    label = torch.from_numpy(rng.integers(0, 5, hw).astype(np.int64))
    got = random_scale_crop_flip(img, label, crop,
                                 torch.Generator().manual_seed(4))
    draws = draw_scale_crop_flip(1, hw, crop,
                                 torch.Generator().manual_seed(4))
    want = scale_crop_flip(img[None], label[None], crop, *draws)
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[1][0])
    assert got[1].dtype == torch.int64
