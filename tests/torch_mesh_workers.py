"""Rank workers of the port's mesh tests (`tests/test_torch_mesh*.py`).

`spawn_ranks(world, tmp, task, job)` starts `world` processes with
`torch.multiprocessing` (spawn), each a gloo rank on the CPU with torch on
one intra-op thread, joined through a file store in `tmp`; each runs the
function of this module named `task` on the pickled `job` and pickles
what it returns.  The spawn has a deadline, and a rank that raises fails
it.  This module imports no JAX: the ranks load only torch and the port.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.multiprocessing as mp
import torch.nn as nn

SPAWN_TIMEOUT_S = 120.0


def spawn_ranks(world: int, tmp, task: str, job, timeout=SPAWN_TIMEOUT_S):
    """[the value of `task(rank, world, job)` for each rank]."""
    tmp = str(tmp)
    with open(os.path.join(tmp, "job.pkl"), "wb") as f:
        pickle.dump(job, f)
    ctx = mp.start_processes(_rank_main, args=(world, tmp, task),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{task}: {world} ranks not done in "
                               f"{timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, tmp: str, task: str) -> None:
    import torch.distributed as dist

    from mspl_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed(rank, world, f"file://{tmp}/store",
                     timeout_s=SPAWN_TIMEOUT_S)
    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    out = globals()[task](rank, world, job)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shared pieces: data sets, sources, models
# ---------------------------------------------------------------------------

class Images:
    """An in-memory target set: uint8 images [N, H, W, 3], labels [N, H, W]
    (all ignore unless given)."""

    def __init__(self, images, labels=None):
        self.images = np.asarray(images)
        self.labels = (np.full(self.images.shape[:3], 255, np.int32)
                       if labels is None else np.asarray(labels))
        self.num_classes = 3

    def __len__(self):
        return len(self.images)

    @property
    def shape_hw(self):
        return self.images.shape[1:3]

    def load(self, i):
        return self.images[i], self.labels[i]


class Planes(nn.Module):
    """A deterministic 'model': logit plane c is input channel c % 3 times
    ((c % 5) - 2) * scale, channel-major, as the JAX package's
    tests/test_parallel.py builds its heterogeneous sources."""

    def __init__(self, n_cls: int, scale: float):
        super().__init__()
        self.n_cls, self.scale = n_cls, scale

    def forward(self, x):
        return torch.stack([x[:, c % 3] * ((c % 5) - 2.0) * self.scale
                            for c in range(self.n_cls)], dim=1)


HETERO = (("camvid", 11, 1.0), ("cityscapes", 19, 0.7), ("forest", 5, 1.3))


def hetero_sources():
    from mspl_tpu_torch.pseudo.generate import make_source

    return [make_source(name, Planes(c, scale), None, name,
                        channel_major=True, device="cpu")
            for name, c, scale in HETERO]


def espnet(num_classes: int, variables=None):
    from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
    from mspl_tpu_torch.utils.flax_bridge import load_flax_variables

    model = ESPNetv2Segmentation(num_classes, s=0.5, dec_base_planes=8)
    if variables is not None:
        load_flax_variables(model, variables)
    return model


def state_numpy(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------

def generate_cases(rank, world, job):
    """Each of `job["cases"]` (name, data, model, mode) through
    `PseudoLabelGenerator(mesh=make_mesh(data, model))` over the hetero
    sources: {name: (labels, confs, indices)}, and one `return_device`
    sweep's labels."""
    from mspl_tpu_torch.data.loader import DataLoader
    from mspl_tpu_torch.parallel.mesh import make_mesh
    from mspl_tpu_torch.pseudo.generate import PseudoLabelGenerator

    data = Images(job["images"])
    sources = hetero_sources()
    out = {}
    for name, d, m, mode in job["cases"]:
        mesh = make_mesh(data=d, model=m)
        gen = PseudoLabelGenerator(sources, mode=mode, kc=job["kc"],
                                   min_agree=job["min_agree"], mesh=mesh,
                                   device="cpu")
        out[name] = gen(DataLoader(data, batch_size=job["batch"],
                                   num_workers=1))
        if name == job["device_case"]:
            lab, conf, idx = gen(DataLoader(data, batch_size=job["batch"],
                                            num_workers=1),
                                 return_device=True)
            out["return_device"] = (lab.numpy(), conf.numpy(), idx)
    return out


def _bn_case(job, mesh, groups):
    from mspl_tpu_torch.layers.conv_blocks import (BatchNorm, bn_stat_groups,
                                                   bn_sync)
    from mspl_tpu_torch.parallel.mesh import shard_batch

    x, g = job["x"], job["g"]
    bn = BatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(job["scale"]))
        bn.bias.copy_(torch.from_numpy(job["bias"]))
    bn.train()
    local = shard_batch({"x": x, "g": g}, mesh)
    xt = torch.from_numpy(local["x"]).requires_grad_(True)
    with bn_stat_groups(groups), bn_sync(mesh.group("data"),
                                         mesh.shape["data"]):
        y = bn(xt)
        (y * torch.from_numpy(local["g"])).sum().backward()
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(),
                mean=bn.running_mean.numpy().copy(),
                var=bn.running_var.numpy().copy(),
                dscale=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy())


def _loss_case(job, mesh):
    from mspl_tpu_torch.engine.losses import segmentation_loss
    from mspl_tpu_torch.parallel.mesh import psum, shard_batch

    local = shard_batch({"logits": job["logits"], "labels": job["labels"]},
                        mesh)
    logits = torch.from_numpy(local["logits"]).requires_grad_(True)
    loss = segmentation_loss(
        logits, torch.from_numpy(local["labels"]),
        class_weights=torch.from_numpy(job["cw"]), reg_mode="kld",
        reg_weight=0.1, group=mesh.group("data"))
    loss.backward()
    return dict(loss=float(psum(loss.detach().clone(), mesh)),
                dlogits=logits.grad.numpy())


def _steps(job, mesh, augment):
    from mspl_tpu_torch.engine.schedules import build_schedule
    from mspl_tpu_torch.engine.train import (create_train_state,
                                             make_train_step,
                                             step_generator)

    model = espnet(job["classes"], job["variables"])
    state = create_train_state(model, "sgd", build_schedule(**job["sched"]),
                               device="cpu")
    step = make_train_step(model, crop_hw=job["crop"],
                           class_weights=job["cw"], augment=augment,
                           device="cpu", mesh=mesh)
    out = []
    for i, batch in enumerate(job["batches"]):
        state, metrics = step(state, batch, step_generator(3, i))
        out.append((float(metrics["loss"]), state_numpy(model)))
    return out


def _evaluate(job, mesh):
    from mspl_tpu_torch.data.loader import DataLoader
    from mspl_tpu_torch.engine.train import evaluate, make_eval_step

    model = espnet(job["classes"], job["variables"])
    data = Images(job["eval_images"], job["eval_labels"])
    return evaluate(make_eval_step(model, job["classes"], device="cpu"),
                    DataLoader(data, batch_size=4, num_workers=1),
                    job["classes"], mesh)


def _classification(job, mesh):
    from mspl_tpu_torch.data.loader import DataLoader
    from mspl_tpu_torch.engine.train_cls import (ClsTrainConfig,
                                                 train_classification)
    from mspl_tpu_torch.models import EESPNet
    from mspl_tpu_torch.utils.flax_bridge import load_flax_variables

    model = EESPNet(s=0.5, num_classes=job["cls_classes"])
    load_flax_variables(model, job["cls_variables"])
    data = ClassSet(job["cls_images"], job["cls_labels"])
    res = train_classification(
        model, None, DataLoader(data, 4, shuffle=True, seed=1,
                                num_workers=1),
        DataLoader(data, 4, num_workers=1),
        ClsTrainConfig(epochs=1, lr=0.05, verbose=False), mesh=mesh,
        device="cpu")
    return dict(history=res["history"], state=state_numpy(model))


class ClassSet:
    """In-memory classification set: uint8 images, integer labels."""

    def __init__(self, images, labels):
        self.images, self.labels = np.asarray(images), np.asarray(labels)

    def __len__(self):
        return len(self.images)

    def load(self, i):
        return self.images[i], self.labels[i]


def _segmentation_loop(job, mesh, ckpt_dir):
    """`train_segmentation` for one epoch (augmented, 2 global batches of
    4) with `ckpt_dir`, the directories this rank's calls of
    `save_checkpoint` wrote to recorded."""
    import mspl_tpu_torch.engine.train as train_mod
    from mspl_tpu_torch.data.loader import DataLoader

    model = espnet(job["classes"], job["variables"])
    data = Images(job["loop_images"], job["loop_labels"])
    saved = []
    real = train_mod.save_checkpoint

    def recording(path, *args, **kw):
        saved.append(path)
        return real(path, *args, **kw)

    train_mod.save_checkpoint = recording
    try:
        res = train_mod.train_segmentation(
            model, None, DataLoader(data, 4, shuffle=True, seed=2,
                                    num_workers=1),
            DataLoader(data, 4, num_workers=1), job["classes"],
            train_mod.TrainLoopConfig(epochs=1, crop_hw=job["crop"],
                                      lr=0.01, ckpt_dir=ckpt_dir,
                                      verbose=False),
            mesh=mesh, device="cpu")
    finally:
        train_mod.save_checkpoint = real
    return dict(history=[(h["loss"], h["miou"]) for h in res["history"]],
                best=res["best_miou"], state=state_numpy(model), saved=saved)


def train_cases(rank, world, job):
    """Synced BatchNorm (global and ghost groups), the loss, SGD steps
    without and with augmentation, `evaluate`, `train_classification` and
    the CLI's `pseudo --model-parallel 2`, at data 2 over 2 ranks; then
    `train_segmentation` and `train_classification` without a mesh and
    with the explicit `make_mesh_for_batch` mesh."""
    from mspl_tpu_torch.cli import main
    from mspl_tpu_torch.parallel.mesh import make_mesh, make_mesh_for_batch

    mesh = make_mesh(data=2)
    out = {f"bn_{name}": _bn_case(case, mesh, groups)
           for name, (case, groups) in job["bn"].items()}
    out["loss"] = _loss_case(job["loss"], mesh)
    out["steps"] = _steps(job, mesh, augment=False)
    out["steps_augment"] = _steps(job, mesh, augment=True)
    out["evaluate"] = _evaluate(job, mesh)
    out["classification"] = _classification(job, mesh)
    out["classification_no_mesh"] = _classification(job, None)
    out["loop_no_mesh"] = _segmentation_loop(job, None, job["ckpt_no_mesh"])
    out["loop_mesh"] = _segmentation_loop(job, make_mesh_for_batch(4),
                                          job["ckpt_mesh"])
    cli = main(job["cli_argv"] + ["--model-parallel", "2"], device="cpu")
    out["cli"] = {"kc": cli["kc"], "kept": cli["kept"], "n": cli["n"]}
    return out


def self_training_round(rank, world, job):
    """One `self_training` round with generation on `make_mesh(data=2)`
    over ranks 0-1 of 3 (rank 2 outside) and the fine-tune on its
    `make_mesh_for_batch`: the history, the tuned weights and, on rank 0,
    the label PNGs in `job["out_dir"]`."""
    from mspl_tpu_torch.data.loader import DataLoader
    from mspl_tpu_torch.parallel.mesh import make_mesh
    from mspl_tpu_torch.pseudo.generate import make_source
    from mspl_tpu_torch.pseudo.self_training import (SelfTrainConfig,
                                                     self_training)

    sources = [make_source(name, espnet(c, v), None, name,
                           channel_major=True, device="cpu")
               for (name, c), v in zip(job["sources"], job["source_vars"])]
    model = espnet(3, job["target_vars"])
    data = Images(job["images"])
    val = Images(job["val_images"], job["val_labels"])
    mesh = make_mesh(data=2)
    res = self_training(model, None, sources, data,
                        DataLoader(val, batch_size=4, num_workers=1), 3,
                        SelfTrainConfig(**job["cfg"],
                                        out_dir=job["out_dir"]),
                        mesh=mesh, device="cpu")
    return dict(history=res["history"], state=state_numpy(model),
                outside=mesh.coords is None)
