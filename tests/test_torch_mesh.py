"""The port's mesh (`mspl_tpu_torch/parallel/`) on the CPU: its layout
against the JAX package's, then data parallelism over spawned gloo ranks
(`tests/torch_mesh_workers.py`, torch on one thread a rank, as the
single-process references here) against flax, the JAX package and the
port's own single-process runs.

Over 2 ranks at data 2 (one spawn): synced BatchNorm's output, running
statistics and gradients on a batch split in two, against flax's
BatchNorm on the whole batch, also with one value a channel on each rank,
and with ghost-batch groups against the JAX package's `bn_stat_groups`;
the loss and its gradients with one shard mostly ignore; 2 SGD steps of a
small ESPNetv2 (tests/test_torch_train.py's case: global batch 2, one
image a rank) against the JAX train step on a data-2 mesh (no
augmentation) and against the port's own steps (with it); `evaluate`;
`train_classification`; the CLI's `pseudo --model-parallel 2`.  Over 3
ranks (another spawn): a self-training round whose meshes leave rank 2
outside, which must end with the weights and labels of the ranks inside.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mspl_tpu.engine.losses import segmentation_loss as jax_loss
from mspl_tpu.engine.schedules import build_schedule as jax_schedule
from mspl_tpu.engine.train import build_optimizer as jax_optimizer
from mspl_tpu.engine.train import create_train_state as jax_state
from mspl_tpu.engine.train import make_train_step as jax_train_step
from mspl_tpu.layers.bn import BatchNorm as JaxGhostBN
from mspl_tpu.layers.bn import bn_stat_groups as jax_bn_groups
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu.parallel import mesh as jax_mesh
from mspl_tpu_torch.cli import _save_model, main
from mspl_tpu_torch.data import native_io
from mspl_tpu_torch.data.label_io import load_label_png
from mspl_tpu_torch.data.loader import DataLoader
from mspl_tpu_torch.engine.losses import segmentation_loss
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import (create_train_state, evaluate,
                                         make_eval_step, make_train_step,
                                         step_generator)
from mspl_tpu_torch.engine.train_cls import (ClsTrainConfig,
                                             train_classification)
from mspl_tpu_torch.layers.conv_blocks import (BatchNorm, bn_stat_groups,
                                               bn_sync)
from mspl_tpu_torch.models import EESPNet, init_model
from mspl_tpu_torch.parallel.mesh import (make_mesh, make_mesh_for_batch,
                                          shard_batch)
from mspl_tpu_torch.pseudo.generate import make_source
from mspl_tpu_torch.pseudo.self_training import (SelfTrainConfig,
                                                 self_training)
from mspl_tpu_torch.utils.flax_bridge import flax_variables as port_tree
from mspl_tpu_torch.utils.flax_bridge import load_flax_variables
from tests.test_torch_model import flax_variables
from tests.test_torch_train import (_batches, _check_sgd, _flax_layout,
                                    _numpy_tree)
from tests.torch_mesh_workers import (ClassSet, Images, espnet,
                                      spawn_ranks, state_numpy)

HW = (32, 48)
CLASSES = 5
SCHED = dict(name="hybrid", base_lr=0.005, total_steps=6, max_lr=0.01,
             cycle_epochs=3)
CROP = (24, 32)
CLS_HW, CLS_CLASSES = (64, 64), 4
CLI_SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))
CLI_WH = (32, 24)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The single-process references on one thread, as each rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the layout, without processes
# ---------------------------------------------------------------------------

def _ids(m):
    return np.vectorize(lambda d: d.id)(m.devices)


@pytest.mark.parametrize("kw", [{}, dict(model=2), dict(model=4),
                                dict(model=2, data=2), dict(data=3)])
def test_make_mesh_matches_jax(kw):
    """The grid of 8 ranks is JAX's grid of its 8 devices: `model` outer,
    `data` innermost."""
    got, want = make_mesh(ranks=range(8), **kw), jax_mesh.make_mesh(**kw)
    assert got.shape == dict(want.shape)
    np.testing.assert_array_equal(got.grid, _ids(want))


@pytest.mark.parametrize("kw", [dict(model=3), dict(model=2, data=8)])
def test_make_mesh_errors_match_jax(kw):
    with pytest.raises(ValueError):
        jax_mesh.make_mesh(**kw)
    with pytest.raises(ValueError):
        make_mesh(ranks=range(8), **kw)


@pytest.mark.parametrize("batch,model", [(8, 1), (4, 1), (3, 1), (12, 1),
                                         (8, 2), (6, 2)])
def test_make_mesh_for_batch_matches_jax(batch, model):
    got = make_mesh_for_batch(batch, model=model, ranks=range(8))
    want = jax_mesh.make_mesh_for_batch(batch, model=model)
    assert got.shape == dict(want.shape)
    np.testing.assert_array_equal(got.grid, _ids(want))


def test_shard_batch_and_coordinates():
    """Rank 0 of a mesh it heads holds the first contiguous slice of every
    array, `valid` and `index` with the images."""
    mesh = make_mesh(data=4, ranks=range(8))
    assert mesh.coords == (0, 0) and mesh.is_first
    batch = {"image": np.arange(16 * 2).reshape(16, 2),
             "valid": np.arange(16) < 14, "index": np.arange(16)}
    local = shard_batch(batch, mesh)
    np.testing.assert_array_equal(local["image"], batch["image"][:4])
    np.testing.assert_array_equal(local["index"], np.arange(4))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"image": np.zeros((6, 2))}, mesh)
    outside = make_mesh(data=2, ranks=[3, 5])
    assert outside.coords is None and not outside.is_first
    with pytest.raises(ValueError, match="outside"):
        outside.index("data")


def test_ghost_groups_must_tile_the_data_axis():
    """Under a data axis of 2, `bn_stat_groups(3)` has no per-rank form."""
    bn = BatchNorm(3).train()
    with bn_stat_groups(3), bn_sync(None, 2), \
            pytest.raises(ValueError, match="multiple of 2"):
        bn(torch.zeros(6, 3, 2, 2))


# ---------------------------------------------------------------------------
# two ranks at data 2
# ---------------------------------------------------------------------------

def _bn_job(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[1]
    return dict(x=rng.normal(3.0, 2.0, shape).astype(np.float32),
                g=rng.normal(0.0, 1.0, shape).astype(np.float32),
                scale=rng.uniform(0.5, 1.5, c).astype(np.float32),
                bias=rng.normal(0.0, 0.5, c).astype(np.float32))


BN_CASES = {"global": (_bn_job(1, (4, 6, 5, 7)), 1),
            "one_value_a_rank": (_bn_job(2, (2, 6, 1, 1)), 1),
            "ghost2": (_bn_job(3, (4, 6, 5, 7)), 2),
            "ghost4": (_bn_job(4, (8, 6, 3, 5)), 4)}


def _loss_job():
    """Logits and labels of 4 rows whose second half (rank 1's shard) is
    95% ignore, the first 10%."""
    rng = np.random.default_rng(5)
    labels = rng.integers(0, CLASSES, (4, 6, 7)).astype(np.int32)
    ignore = rng.random(labels.shape) < np.where(
        np.arange(4) < 2, 0.1, 0.95)[:, None, None]
    labels[ignore] = 255
    return dict(logits=rng.normal(0, 2, (4, CLASSES, 6, 7)).astype(
        np.float32), labels=labels,
        cw=rng.uniform(0.5, 2.0, CLASSES).astype(np.float32))


def _png_set(root, n, seed):
    """A greenhouse target set of `n` PNGs and its list file."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        names.append(f"img_{i}.png")
        native_io.encode_png(os.path.join(root, names[-1]), rng.integers(
            0, 255, (CLI_WH[1], CLI_WH[0], 3), dtype=np.uint8))
    lst = os.path.join(root, "unlabeled.txt")
    with open(lst, "w") as f:
        f.writelines(n + "\n" for n in names)
    return lst


def _cli_job(tmp):
    """Three seeded source checkpoints, a target set and the argv of
    `pseudo` (soft fusion, kc from --p)."""
    ckpts = []
    for i, (name, c) in enumerate(CLI_SOURCES):
        model = init_model(espnet(c), torch.Generator().manual_seed(20 + i))
        ck = str(tmp / f"ckpt_{name}")
        _save_model(ck, port_tree(model),
                    {"dataset": name, "model": "espnetv2", "s": 0.5,
                     "num_classes": c, "bf16": False,
                     "input_hw": [CLI_WH[1], CLI_WH[0]], "in_channels": 3,
                     "dec_base_planes": 8})
        ckpts.append(ck)
    root = str(tmp / "target")
    lst = _png_set(root, 8, seed=9)
    return ["pseudo", "--checkpoints", *ckpts, "--data-root", root,
            "--target-list", lst, "--size", str(CLI_WH[0]),
            str(CLI_WH[1]), "--batch-size", "4", "--p", "0.5"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_two")
    rng = np.random.default_rng(8)
    batches = _batches(2)  # of 2: one image a rank
    b0 = batches[0]
    hist = np.bincount(b0["label"][b0["label"] != 255], minlength=CLASSES)
    cls_model = init_model(EESPNet(s=0.5, num_classes=CLS_CLASSES),
                           torch.Generator().manual_seed(3))
    cli_argv = _cli_job(tmp)
    job = dict(
        bn=BN_CASES, loss=_loss_job(), classes=CLASSES,
        variables=flax_variables(FlaxESPNetv2(
            num_classes=CLASSES, s=0.5, dec_base_planes=8), HW, seed=11),
        batches=batches, cw=(1.0 / np.log(1.02 + hist / hist.sum())).astype(
            np.float32),
        sched=dict(SCHED), crop=CROP,
        eval_images=rng.integers(0, 256, (8, *HW, 3), dtype=np.uint8),
        eval_labels=rng.integers(0, CLASSES, (8, *HW)).astype(np.int32),
        cls_classes=CLS_CLASSES, cls_variables=port_tree(cls_model),
        cls_images=rng.integers(0, 256, (8, *CLS_HW, 3), dtype=np.uint8),
        cls_labels=rng.integers(0, CLS_CLASSES, 8).astype(np.int32),
        cli_argv=cli_argv + ["--out-dir", str(tmp / "cli_mesh")],
        loop_images=rng.integers(0, 256, (8, *HW, 3), dtype=np.uint8),
        loop_labels=rng.integers(0, CLASSES, (8, *HW)).astype(np.int32),
        ckpt_no_mesh=str(tmp / "ckpt_no_mesh"),
        ckpt_mesh=str(tmp / "ckpt_mesh"))
    ranks = spawn_ranks(2, tmp, "train_cases", job)
    return dict(job=job, ranks=ranks, tmp=tmp, cli_argv=cli_argv)


def _flax_bn(case, groups):
    """flax's BatchNorm (the JAX package's under `bn_stat_groups`) on the
    whole NHWC batch: output, new running statistics, d(sum(y * g)) by x,
    scale and bias, all in NCHW."""
    x = jnp.asarray(case["x"].transpose(0, 2, 3, 1))
    g = jnp.asarray(case["g"].transpose(0, 2, 3, 1))
    c = x.shape[-1]
    mod = (JaxGhostBN if groups > 1 else nn.BatchNorm)(
        use_running_average=False, momentum=0.9, epsilon=1e-5)
    params = {"scale": jnp.asarray(case["scale"]),
              "bias": jnp.asarray(case["bias"])}
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

    def f(x, params):
        with jax_bn_groups(groups):
            y, upd = mod.apply({"params": params, "batch_stats": stats}, x,
                               mutable=["batch_stats"])
        return (y * g).sum(), (y, upd["batch_stats"])

    (_, (y, new)), (dx, dp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(x, params)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return dict(y=nchw(y), dx=nchw(dx), mean=np.asarray(new["mean"]),
                var=np.asarray(new["var"]), dscale=np.asarray(dp["scale"]),
                dbias=np.asarray(dp["bias"]))


@pytest.mark.parametrize("name", sorted(BN_CASES))
def test_synced_batchnorm_matches_flax_on_the_whole_batch(two_ranks, name):
    """Each rank's output rows and input gradient are flax's on the whole
    batch's; the running statistics, and the parameters' gradients summed
    over the ranks, too: within 2e-5 of the largest element (2e-6 for the
    statistics, absolute and relative), the input
    gradient within 2e-5 of its scale max|g| * max(scale / std) (f32 sums
    in another order; flax's variance is E[x^2] - E[x]^2; with one value
    a rank, two a channel, the exact input gradient is 0 and both leave
    rounding).  `ghost2` (2 groups over 2 ranks) needs no collective in
    the normalization; `ghost4` keeps 2 groups a rank.  Measured: output
    and input gradient 9.2e-7 of their scales at most, statistics 1.1e-6,
    the parameters' gradients 9.9e-7."""
    case, groups = BN_CASES[name]
    want = _flax_bn(case, groups)
    got = [r[f"bn_{name}"] for r in two_ranks["ranks"]]
    std = np.sqrt(case["x"].reshape(groups, -1, *case["x"].shape[1:]).var(
        axis=(1, 3, 4)).min(0) + 1e-5)
    scale = dict(y=np.abs(want["y"]).max(),
                 dx=np.abs(case["g"]).max() * (case["scale"] / std).max())
    for key in ("y", "dx"):
        cat = np.concatenate([g[key] for g in got])
        np.testing.assert_allclose(cat, want[key], rtol=0,
                                   atol=2e-5 * scale[key], err_msg=key)
    for key in ("mean", "var"):
        for g in got:
            np.testing.assert_allclose(g[key], want[key], rtol=2e-6,
                                       atol=2e-6, err_msg=key)
    for key in ("dscale", "dbias"):
        total = got[0][key] + got[1][key]
        np.testing.assert_allclose(total, want[key], rtol=0,
                                   atol=2e-5 * np.abs(want[key]).max(),
                                   err_msg=key)


def test_loss_takes_the_global_denominator(two_ranks):
    """One shard 95% ignore: the global loss and each rank's logits'
    gradients equal the single-process loss on the whole batch and JAX's
    (CE with class weights plus the kld regularizer), where the mean of
    the two shards' means is off by more than 1%."""
    job = two_ranks["job"]["loss"]
    got = [r["loss"] for r in two_ranks["ranks"]]
    kw = dict(reg_mode="kld", reg_weight=0.1)
    logits = torch.from_numpy(job["logits"]).requires_grad_(True)
    single = segmentation_loss(logits, torch.from_numpy(job["labels"]),
                               class_weights=torch.from_numpy(job["cw"]),
                               **kw)
    single.backward()
    want, dwant = jax.value_and_grad(lambda z: jax_loss(
        z, jnp.asarray(job["labels"]), class_weights=jnp.asarray(job["cw"]),
        channel_axis=1, **kw))(jnp.asarray(job["logits"]))
    for g in got:
        np.testing.assert_allclose(g["loss"], single.item(), rtol=1e-6)
        np.testing.assert_allclose(g["loss"], float(want), rtol=1e-6)
    cat = np.concatenate([g["dlogits"] for g in got])
    scale = np.abs(np.asarray(dwant)).max()
    np.testing.assert_allclose(cat, logits.grad.numpy(), rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(cat, np.asarray(dwant), rtol=0,
                               atol=1e-5 * scale)
    halves = [segmentation_loss(
        torch.from_numpy(job["logits"][s]),
        torch.from_numpy(job["labels"][s]),
        class_weights=torch.from_numpy(job["cw"]), **kw).item()
        for s in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(halves) - single.item()) > 0.01 * single.item()


def _jax_mesh_steps(job):
    """The JAX train step on a data-2 mesh of its devices: the loss and
    (params, batch_stats) after each step."""
    model = FlaxESPNetv2(num_classes=CLASSES, s=0.5, dec_base_planes=8,
                         channel_major_logits=True)
    sched = jax_schedule(SCHED["name"], SCHED["base_lr"],
                         SCHED["total_steps"], max_lr=SCHED["max_lr"],
                         cycle_epochs=SCHED["cycle_epochs"])
    mesh = jax_mesh.make_mesh(data=2)
    state = jax_mesh.replicate(jax_state(model, job["variables"],
                                         jax_optimizer("sgd", sched)), mesh)
    step = jax_train_step(model, class_weights=job["cw"], augment=False,
                          donate=False)
    out = []
    for i, batch in enumerate(job["batches"]):
        state, metrics = step(state, jax_mesh.shard_batch(batch, mesh),
                              jax.random.PRNGKey(i))
        out.append((float(metrics["loss"]), _numpy_tree(
            {"params": state.params, "batch_stats": state.batch_stats})))
    return out


def _single_steps(job, augment):
    model = espnet(CLASSES, job["variables"])
    state = create_train_state(model, "sgd", build_schedule(**SCHED),
                               device="cpu")
    step = make_train_step(model, crop_hw=CROP, class_weights=job["cw"],
                           augment=augment, device="cpu")
    out = []
    for i, batch in enumerate(job["batches"]):
        state, metrics = step(state, batch, step_generator(3, i))
        out.append((float(metrics["loss"]), state_numpy(model)))
    return out


def _as_port(state, like):
    ref = espnet(CLASSES)
    ref.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return ref


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_sgd_steps_match_jax_on_a_data2_mesh(two_ranks, rank):
    """2 SGD steps at data 2 without augmentation against the JAX train
    step on a data-2 mesh, within `tests/test_torch_train.py`'s bounds
    (`_check_sgd`: loss 1e-6 then 1e-5 relative, parameters 1e-6 + 1e-5
    then 1e-5 + 1e-4 relative, statistics 1e-5 then 1e-4).  Measured:
    loss 7.0e-7 then 1.2e-7 relative, the largest |d| / (|ref| + 0.1)
    7.1e-6 then 2.4e-5."""
    job = two_ranks["job"]
    like = espnet(CLASSES)
    for i, ((loss, state), (want_loss, want_tree)) in enumerate(zip(
            two_ranks["ranks"][rank]["steps"], _jax_mesh_steps(job))):
        _check_sgd(i, loss, want_loss, _as_port(state, like),
                   _flax_layout(want_tree, like))


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_mesh_sgd_steps_match_single_process(two_ranks, augment):
    """The same 2 steps against the port's single-process steps on the
    global batches (with augmentation: the crops drawn for the global
    batch), within the same bounds; both ranks hold the same state, bit
    for bit.  Measured: loss 3.2e-7 then 1.2e-7 relative, the largest |d|
    / (|ref| + 0.1) 1.2e-6 then 2.2e-6 (with the crops 0 and 6.4e-8,
    3.9e-6 and 1.8e-5)."""
    key = "steps_augment" if augment else "steps"
    like = espnet(CLASSES)
    r0, r1 = (r[key] for r in two_ranks["ranks"])
    for i, ((loss, state), (want_loss, want)) in enumerate(zip(
            r0, _single_steps(two_ranks["job"], augment))):
        _check_sgd(i, loss, want_loss, _as_port(state, like),
                   _as_port(want, like))
        assert r1[i][0] == loss
        for k, v in state.items():
            np.testing.assert_array_equal(r1[i][1][k], v, err_msg=k)


def test_evaluate_sums_the_confusion_over_the_mesh(two_ranks):
    job = two_ranks["job"]
    model = espnet(CLASSES, job["variables"])
    iou, miou = evaluate(make_eval_step(model, CLASSES, device="cpu"),
                         DataLoader(Images(job["eval_images"],
                                           job["eval_labels"]),
                                    batch_size=4, num_workers=1), CLASSES)
    for r in two_ranks["ranks"]:
        np.testing.assert_array_equal(r["evaluate"][0], iou)
        assert r["evaluate"][1] == miou


def test_train_classification_on_the_mesh(two_ranks):
    """2 steps of the classifier at data 2 (dropout drawn for the global
    batch) against the single-process run: the loss within 1e-6 relative
    and the accuracy, then every parameter and statistic within 1e-5 +
    1e-4 relative (measured: loss 2.4e-7 relative, the largest |d| /
    (|ref| + 0.1) 5.0e-6); both ranks equal, bit for bit."""
    job = two_ranks["job"]
    model = EESPNet(s=0.5, num_classes=CLS_CLASSES)
    load_flax_variables(model, job["cls_variables"])
    data = ClassSet(job["cls_images"], job["cls_labels"])
    res = train_classification(
        model, None, DataLoader(data, 4, shuffle=True, seed=1,
                                num_workers=1),
        DataLoader(data, 4, num_workers=1),
        ClsTrainConfig(epochs=1, lr=0.05, verbose=False), device="cpu")
    want = state_numpy(model)
    r0, r1 = (r["classification"] for r in two_ranks["ranks"])
    for got in (r0, r1):
        (h,), (w,) = got["history"], res["history"]
        np.testing.assert_allclose(h["loss"], w["loss"], rtol=1e-6)
        assert h["acc"] == w["acc"]
    for k, v in want.items():
        np.testing.assert_allclose(r0["state"][k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_array_equal(r1["state"][k], r0["state"][k],
                                      err_msg=k)


def test_training_without_a_mesh_takes_the_job_data_mesh(two_ranks):
    """With `torch.distributed` up and no mesh given, `train_segmentation`
    and `train_classification` train on `make_mesh_for_batch(batch)`, as
    the reference defaults: bit for bit the explicit mesh's run, the same
    weights on both ranks, and only rank 0 writes the checkpoints."""
    r0, r1 = two_ranks["ranks"]
    for r in (r0, r1):
        got, want = r["loop_no_mesh"], r["loop_mesh"]
        assert got["history"] == want["history"]
        assert got["best"] == want["best"]
        for k, v in want["state"].items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        cg, cw = r["classification_no_mesh"], r["classification"]
        assert cg["history"] == cw["history"]
        for k, v in cw["state"].items():
            np.testing.assert_array_equal(cg["state"][k], v, err_msg=k)
    for k, v in r0["loop_no_mesh"]["state"].items():
        np.testing.assert_array_equal(r1["loop_no_mesh"]["state"][k], v,
                                      err_msg=k)
    job = two_ranks["job"]
    assert r0["loop_no_mesh"]["saved"] == [job["ckpt_no_mesh"]]
    assert r0["loop_mesh"]["saved"] == [job["ckpt_mesh"]]
    assert r1["loop_no_mesh"]["saved"] == [] == r1["loop_mesh"]["saved"]
    assert os.listdir(job["ckpt_no_mesh"])


def test_cli_pseudo_model_parallel_matches_single_process(two_ranks):
    """`pseudo --model-parallel 2` in each of 2 ranks (sources 0 and 2 on
    rank 0, source 1 on rank 1, the sums added over the model axis) writes
    rank 0's label PNGs equal to a single-process `pseudo`'s."""
    tmp = two_ranks["tmp"]
    out = str(tmp / "cli_single")
    res = main(two_ranks["cli_argv"] + ["--out-dir", out], device="cpu")
    mesh_dir = tmp / "cli_mesh"
    names = sorted(f for f in os.listdir(out) if f.startswith("pseudo_"))
    assert len(names) == 8
    assert sorted(f for f in os.listdir(mesh_dir)
                  if f.startswith("pseudo_")) == names
    for f in names:
        np.testing.assert_array_equal(
            load_label_png(str(mesh_dir / f)),
            load_label_png(os.path.join(out, f)), err_msg=f)
    for r in two_ranks["ranks"]:
        np.testing.assert_allclose(r["cli"]["kc"], res["kc"], rtol=0,
                                   atol=1e-6)
        assert r["cli"]["kept"] == res["kept"] and r["cli"]["n"] == 8


# ---------------------------------------------------------------------------
# three ranks: a self-training round with a rank outside
# ---------------------------------------------------------------------------

ROUND_SOURCES = (("camvid", 11), ("forest", 5))
ROUND_CFG = dict(rounds=1, batch_size=4, epochs_per_round=1,
                 crop_hw=CROP, p_init=0.5, verbose=False)


@pytest.fixture(scope="module")
def round_three(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_round")
    rng = np.random.default_rng(12)
    job = dict(
        sources=ROUND_SOURCES,
        source_vars=[flax_variables(FlaxESPNetv2(
            num_classes=c, s=0.5, dec_base_planes=8), HW, seed=30 + i)
            for i, (_, c) in enumerate(ROUND_SOURCES)],
        target_vars=flax_variables(FlaxESPNetv2(
            num_classes=3, s=0.5, dec_base_planes=8), HW, seed=40),
        images=rng.integers(0, 256, (8, *HW, 3), dtype=np.uint8),
        val_images=rng.integers(0, 256, (4, *HW, 3), dtype=np.uint8),
        val_labels=rng.integers(0, 3, (4, *HW)).astype(np.int32),
        cfg=ROUND_CFG, out_dir=str(tmp / "mesh_out"))
    ranks = spawn_ranks(3, tmp, "self_training_round", job)

    sources = [make_source(name, espnet(c, v), None, name,
                           channel_major=True, device="cpu")
               for (name, c), v in zip(job["sources"], job["source_vars"])]
    model = espnet(3, job["target_vars"])
    single = self_training(
        model, None, sources, Images(job["images"]),
        DataLoader(Images(job["val_images"], job["val_labels"]),
                   batch_size=4, num_workers=1), 3,
        SelfTrainConfig(**ROUND_CFG, out_dir=str(tmp / "single_out")),
        device="cpu")
    return dict(ranks=ranks, single=single, single_state=state_numpy(model),
                tmp=tmp)


def test_rank_outside_the_mesh_ends_with_the_same_model(round_three):
    """Rank 2 lies outside both meshes: it sweeps nothing and trains
    nothing, yet ends the round with the weights and history of ranks 0
    and 1, bit for bit."""
    r0, r1, r2 = round_three["ranks"]
    assert [r["outside"] for r in (r0, r1, r2)] == [False, False, True]
    for r in (r1, r2):
        assert r["history"] == r0["history"]
        for k, v in r0["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


def test_mesh_round_matches_single_process(round_three):
    """The round's labels (rank 0's PNGs) equal the single-process
    round's, kc and the kept share too; the tuned weights lie within
    1e-5 + 1e-4 relative of its (2 augmented SGD steps at data 2;
    measured: the largest |d| / (|ref| + 0.1) 9.1e-7)."""
    r0 = round_three["ranks"][0]
    (h,), (w,) = r0["history"], round_three["single"]["history"]
    np.testing.assert_allclose(h["kc"], w["kc"], rtol=0, atol=1e-6)
    assert h["frac_kept"] == w["frac_kept"]
    np.testing.assert_allclose(h["miou"], w["miou"], rtol=0, atol=1e-6)
    tmp = round_three["tmp"]
    mesh_dir, single_dir = tmp / "mesh_out" / "round0", \
        tmp / "single_out" / "round0"
    names = sorted(os.listdir(single_dir))
    assert sorted(os.listdir(mesh_dir)) == names and len(names) == 9
    for f in names:
        if f.endswith(".png"):
            np.testing.assert_array_equal(load_label_png(str(mesh_dir / f)),
                                          load_label_png(str(single_dir / f)))
    for k, v in round_three["single_state"].items():
        np.testing.assert_allclose(r0["state"][k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
