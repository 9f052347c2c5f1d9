"""The port's mesh generation against the JAX package's, on the CPU.

Four gloo ranks (spawned, torch on one thread each,
`tests/torch_mesh_workers.py`) run `PseudoLabelGenerator(mesh=...)` at
data 2 (ranks 0-1; ranks 2 and 3 outside the mesh), at (model 2, data 2)
and at (model 3, data 1) (rank 3 outside), soft and hard, with per-class
kc and, for hard fusion, `min_agree`; the JAX package runs
`generate_pseudo_labels(mesh=make_mesh(...))` over the same meshes of its
8 forced CPU devices.  The sources are the JAX package's heterogeneous
deterministic 'models' of tests/test_parallel.py (CamVid 11, Cityscapes
19, Forest 5 classes), written once in each framework with the same
arithmetic, channel-major: the data axis runs the fused pass ① (its plain
version here, the Pallas kernel in interpret mode there), the model axis
the f32 fusion of both packages.  Every rank, inside the mesh or not,
must return every image: labels equal to JAX's, confidences within 1e-6,
indices equal."""

import jax.numpy as jnp
import numpy as np
import pytest

from mspl_tpu.data.label_space import label_conversion_matrix
from mspl_tpu.data.loader import DataLoader as JaxDataLoader
from mspl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mspl_tpu.pseudo.generate import SourceModel, generate_pseudo_labels
from tests.torch_mesh_workers import HETERO, Images, spawn_ranks

HW = (16, 24)
N_IMAGES, BATCH = 10, 4  # three batches, the tail one padded
KC = np.asarray([0.3, 0.5, 0.4], np.float32)
MIN_AGREE = 2
WORLD = 4
# (name, data, model): the JAX mesh takes as many of its devices
MESHES = (("data2", 2, 1), ("model2_data2", 2, 2), ("model3", 1, 3))
CASES = tuple((f"{name}_{mode}", d, m, mode) for name, d, m in MESHES
              for mode in ("soft", "hard"))


def _jax_sources():
    def mk(name, n_cls, scale):
        def apply_fn(imgs):
            planes = [imgs[..., c % 3] * ((c % 5) - 2.0) * scale
                      for c in range(n_cls)]
            return jnp.transpose(jnp.stack(planes, axis=-1), (0, 3, 1, 2))
        return SourceModel(name, apply_fn, label_conversion_matrix(name),
                           channel_major=True)

    return [mk(*h) for h in HETERO]


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    images = np.random.default_rng(5).integers(
        0, 256, (N_IMAGES, *HW, 3), dtype=np.uint8)
    job = dict(images=images, batch=BATCH, kc=KC, min_agree=MIN_AGREE,
               cases=CASES, device_case="model2_data2_soft")
    got = spawn_ranks(WORLD, tmp_path_factory.mktemp("mesh_gen"),
                      "generate_cases", job)
    want = {}
    for name, d, m, mode in CASES:
        want[name] = generate_pseudo_labels(
            _jax_sources(), JaxDataLoader(Images(images), batch_size=BATCH,
                                          num_workers=1),
            mode=mode, kc=KC, min_agree=MIN_AGREE,
            mesh=jax_make_mesh(data=d, model=m))
    return got, want


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_generation_matches_jax(sweeps, case, rank):
    got, want = sweeps
    (gl, gc, gi), (wl, wc, wi) = got[rank][case], want[case]
    assert gl.shape == wl.shape == (N_IMAGES, *HW)
    assert gl.dtype == np.int32 and gc.dtype == np.float32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-6)
    # the thresholds and the vote gate did act: some pixels kept, some not
    assert 0 < (gl == 255).mean() < 1


@pytest.mark.parametrize("rank", range(WORLD))
def test_return_device_matches_the_host_sweep(sweeps, rank):
    got, _ = sweeps
    lab, conf, idx = got[rank]["return_device"]
    hl, hc, hi = got[rank]["model2_data2_soft"]
    assert lab.dtype == np.uint8
    np.testing.assert_array_equal(lab.astype(np.int32), hl)
    np.testing.assert_array_equal(conf, hc)
    np.testing.assert_array_equal(idx, hi)
