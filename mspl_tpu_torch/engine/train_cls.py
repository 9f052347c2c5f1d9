"""Classification pretraining engine (port of mspl_tpu/engine/train_cls.py):
the ESPNetv2 encoder pretrained as a classifier (`EESPNet(num_classes=N)`),
whose encoder then initializes a segmentation model.

`make_cls_train_step` normalizes the batch, runs the classifier's train
forward (BatchNorm on batch statistics, dropout drawn from the step's
generator), the mean integer-label cross entropy, the backward and one
optimizer update at the scheduled lr; it reports the loss and the top-1
accuracy.  `make_cls_eval_step` counts the correct predictions among the
rows the loader marks valid.  `train_classification` is the epoch loop, on
one device (the mesh is ROADMAP A.6).  Like the other entry points, they
move the model to the card unless the caller passes `device="cpu"`.

`encoder_variables_from_classifier` and `load_pretrained_encoder` work on
flax-layout variable trees, as the reference's do; `copy_encoder`
(`models/espnetv2.py`) does the same on modules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mspl_tpu_torch.data.transforms import normalize
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import (TrainState, _norm_kw, _on,
                                         create_train_state, step_generator)
from mspl_tpu_torch.pseudo.generate import load_variables
from mspl_tpu_torch.utils.print_utils import print_log_message

_ENCODER_PREFIXES = ("level1", "level2_0", "level3_0", "level3_blocks",
                     "level4_0", "level4_blocks")


def make_cls_train_step(model: nn.Module, mean=None, std=None, *,
                        device="cuda"):
    """Returns `step(state, batch, rng=None) -> (state, {"loss", "acc"})`
    for the classifier `model`, which moves to `device`.  `batch`: "image"
    uint8 [B, H, W, C] and "label" integer [B].  Dropout draws from `rng`
    (by default `step_generator(0, state.step)`).  The loss and the
    accuracy are 0-d f32 tensors on `device`."""
    device = torch.device(device)
    model.to(device)
    norm_kw = _norm_kw(mean, std)

    def step(state: TrainState, batch: Dict,
             rng: Optional[torch.Generator] = None):
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        model.train()
        imgs = normalize(_on(batch, "image", device), **norm_kw)
        labels = _on(batch, "label", device).long()
        logits = model(imgs, rng if rng is not None
                       else step_generator(0, state.step))
        loss = F.cross_entropy(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return state, {"loss": loss.detach(), "acc": acc}

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
    trained in place.  Returns {'state', 'history', 'best_acc'}."""
    if mesh is not None:
        raise NotImplementedError("a device mesh belongs to a later slice "
                                  "of the PyTorch port (ROADMAP A.6)")
    if variables is not None:
        load_variables(model, variables)
    steps_per_epoch = max(len(train_loader), 1)
    schedule = build_schedule(cfg.scheduler, cfg.lr,
                              cfg.epochs * steps_per_epoch,
                              steps_per_epoch=steps_per_epoch)
    state = create_train_state(model, cfg.optimizer, schedule, cfg.momentum,
                               cfg.weight_decay, device=device)
    train_step = make_cls_train_step(model, device=device)
    eval_step = make_cls_eval_step(model, device=device)

    history = []
    best_acc = -1.0
    for epoch in range(cfg.epochs):
        losses = []
        for batch in train_loader:
            state, m = train_step(state, batch,
                                  step_generator(cfg.seed, state.step))
            losses.append(m["loss"])
        loss = (float(torch.stack(losses).mean().cpu()) if losses else 0.0)
        acc = None
        if val_loader is not None:
            num = den = 0
            for batch in val_loader:
                c, t = eval_step(batch)
                num += int(c)
                den += int(t)
            acc = num / max(den, 1)
            best_acc = max(best_acc, acc)
        history.append({"epoch": epoch, "loss": loss, "acc": acc})
        if cfg.verbose:
            print_log_message(
                f"cls epoch {epoch}: loss {loss:.4f}"
                + (f" val acc {acc:.4f}" if acc is not None else ""))
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
