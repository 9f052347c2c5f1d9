"""Classification pretraining engine (port of mspl_tpu/engine/train_cls.py):
the ESPNetv2 encoder pretrained as a classifier (`EESPNet(num_classes=N)`),
whose encoder then initializes a segmentation model.

`make_cls_train_step` normalizes the batch, runs the classifier's train
forward (BatchNorm on batch statistics, dropout drawn from the step's
generator), the mean integer-label cross entropy, the backward and one
optimizer update at the scheduled lr; it reports the loss and the top-1
accuracy.  `make_cls_eval_step` counts the correct predictions among the
rows the loader marks valid.  `train_classification` is the epoch loop.
Like the other entry points, they move the model to the card unless the
caller passes `device="cpu"`.  Under a mesh (`parallel/mesh.py`) the
step takes its data slice of the global batch, draws the dropout mask for
the global batch and keeps its rows, takes BatchNorm's statistics and the
cross entropy's mean over the global batch and sums the gradients over
the data axis, as `engine/train.py` does for segmentation.

`encoder_variables_from_classifier` and `load_pretrained_encoder` work on
flax-layout variable trees, as the reference's do; `copy_encoder`
(`models/espnetv2.py`) does the same on modules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from mspl_tpu_torch.data.transforms import normalize
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import (TrainState, _bn_context, _norm_kw,
                                         _on, create_train_state, data_axis,
                                         data_rows, step_generator,
                                         sum_grads)
from mspl_tpu_torch.parallel.mesh import (barrier, make_mesh_for_batch, psum,
                                          replicate, shard_batch,
                                          share_with_outside)
from mspl_tpu_torch.utils.flax_bridge import load_variables
from mspl_tpu_torch.utils.print_utils import print_log_message

_ENCODER_PREFIXES = ("level1", "level2_0", "level3_0", "level3_blocks",
                     "level4_0", "level4_blocks")


def make_cls_train_step(model: nn.Module, mean=None, std=None, *,
                        device="cuda", mesh=None):
    """Returns `step(state, batch, rng=None) -> (state, {"loss", "acc"})`
    for the classifier `model`, which moves to `device`.  `batch`: "image"
    uint8 [B, H, W, C] and "label" integer [B].  Dropout draws from `rng`
    (by default `step_generator(0, state.step)`).  The loss and the
    accuracy are 0-d f32 tensors on `device`.  With `mesh`, `batch` is the
    global batch and the step the data-parallel one of the module
    docstring; the loss and accuracy returned are the global batch's."""
    device = torch.device(device)
    model.to(device)
    norm_kw = _norm_kw(mean, std)
    group, sync = data_axis(mesh)

    def step(state: TrainState, batch: Dict,
             rng: Optional[torch.Generator] = None):
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        model.train()
        batch, rows = data_rows(batch, mesh)
        total = len(batch["label"]) if rows is None else rows[1]
        imgs = normalize(_on(batch, "image", device), **norm_kw)
        labels = _on(batch, "label", device).long()
        state.optimizer.zero_grad(set_to_none=True)
        with _bn_context(1, sync):
            logits = model(imgs, rng if rng is not None
                           else step_generator(0, state.step), rows)
            # the mean over the global batch: this rank's sum over its size
            loss = F.cross_entropy(logits, labels, reduction="sum") / total
            loss.backward()
        correct = (logits.detach().argmax(-1) == labels).float().sum()
        out = torch.stack([loss.detach(), correct / total])
        if mesh is not None:
            sum_grads(model.parameters(), group)
            psum(out, mesh)
        lr = state.schedule(state.step)
        for pg in state.optimizer.param_groups:
            pg["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return state, {"loss": out[0], "acc": out[1]}

    return step


def make_cls_eval_step(model: nn.Module, mean=None, std=None, *,
                       device="cuda"):
    """Returns `step(batch) -> (correct, valid)`: the count of valid rows
    whose argmax is their label and the count of valid rows (the batch's
    "valid" mask, all rows without one), int64 tensors on `device`."""
    device = torch.device(device)
    model.to(device)
    norm_kw = _norm_kw(mean, std)

    def step(batch: Dict):
        model.eval()
        with torch.inference_mode():
            logits = model(normalize(_on(batch, "image", device), **norm_kw))
            labels = _on(batch, "label", device)
            valid = _on(batch, "valid", device)
            if valid is None:
                valid = torch.ones_like(labels, dtype=torch.bool)
            correct = (logits.argmax(-1) == labels) & valid.bool()
            return correct.sum(), valid.bool().sum()

    return step


@dataclass
class ClsTrainConfig:
    epochs: int = 90
    lr: float = 0.1
    scheduler: str = "poly"
    optimizer: str = "sgd"
    momentum: float = 0.9
    weight_decay: float = 4e-5
    seed: int = 0
    verbose: bool = True


def train_classification(model: nn.Module, variables, train_loader,
                         val_loader, cfg: ClsTrainConfig, mesh=None,
                         device="cuda") -> Dict[str, Any]:
    """The pretraining loop: per epoch the train steps (step i's dropout
    drawn from `step_generator(cfg.seed, i)`) and the val top-1 accuracy.
    `variables` (a flax tree or a state dict; None keeps the model's
    weights) are loaded into `model`, which moves to `device` and is
    trained in place.  With `mesh`, every rank of the job runs this call
    with the same loaders and mesh; only the mesh's first rank logs, and
    ranks outside the mesh receive the weights and the result.  Returns
    {'state', 'history', 'best_acc'}.  With `torch.distributed`
    initialized and no mesh given, the mesh is
    `make_mesh_for_batch(train_loader.batch_size)`, as the reference's."""
    if mesh is None and dist.is_initialized():
        mesh = make_mesh_for_batch(train_loader.batch_size)
    if variables is not None:
        load_variables(model, variables)
    steps_per_epoch = max(len(train_loader), 1)
    schedule = build_schedule(cfg.scheduler, cfg.lr,
                              cfg.epochs * steps_per_epoch,
                              steps_per_epoch=steps_per_epoch)
    state = create_train_state(model, cfg.optimizer, schedule, cfg.momentum,
                               cfg.weight_decay, device=device)
    history = []
    best_acc = -1.0
    if mesh is not None:
        replicate(model, mesh)
    if mesh is None or mesh.coords is not None:
        train_step = make_cls_train_step(model, device=device, mesh=mesh)
        eval_step = make_cls_eval_step(model, device=device)
        for epoch in range(cfg.epochs):
            losses = []
            for batch in train_loader:
                state, m = train_step(state, batch,
                                      step_generator(cfg.seed, state.step))
                losses.append(m["loss"])
            loss = (float(torch.stack(losses).mean().cpu()) if losses
                    else 0.0)
            acc = None
            if val_loader is not None:
                counts = torch.zeros(2, dtype=torch.int64, device=device)
                for batch in val_loader:
                    if mesh is not None:
                        batch = shard_batch(batch, mesh)
                    counts += torch.stack(eval_step(batch))
                if mesh is not None:
                    psum(counts, mesh)
                num, den = counts.tolist()
                acc = num / max(den, 1)
                best_acc = max(best_acc, acc)
            history.append({"epoch": epoch, "loss": loss, "acc": acc})
            if cfg.verbose and (mesh is None or mesh.is_first):
                print_log_message(
                    f"cls epoch {epoch}: loss {loss:.4f}"
                    + (f" val acc {acc:.4f}" if acc is not None else ""))
    best_acc, history, state.step = share_with_outside(
        model, mesh, (best_acc, history, state.step))
    if mesh is not None:
        barrier()
    return {"state": state, "history": history, "best_acc": best_acc}


def encoder_variables_from_classifier(cls_variables: Dict) -> Dict:
    """The encoder subtree (levels 1-4) of a classifier's flax variables,
    named as a segmentation model's `base_net` holds it."""
    def encoder(tree):
        return {k: v for k, v in tree.items()
                if any(k == p or k.startswith(p + "_")
                       for p in _ENCODER_PREFIXES)}

    return {"params": encoder(cls_variables["params"]),
            "batch_stats": encoder(cls_variables.get("batch_stats", {}))}


def load_pretrained_encoder(seg_variables: Dict, cls_variables: Dict) -> Dict:
    """Segmentation variables with their `base_net` subtree's encoder
    leaves replaced by the classifier's; the inputs are left as they
    are."""
    enc = encoder_variables_from_classifier(cls_variables)
    out = dict(seg_variables)
    for col in ("params", "batch_stats"):
        base = dict(out[col]["base_net"])
        base.update({k: v for k, v in enc[col].items() if k in base})
        out[col] = {**out[col], "base_net": base}
    return out
