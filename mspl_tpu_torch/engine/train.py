"""Train and eval engine (port of mspl_tpu/engine/train.py:
`build_optimizer`, `make_train_step`, `make_eval_step`, `evaluate`,
`TrainLoopConfig`, `train_segmentation`).

Like the port's other entry points, `create_train_state`, `make_train_step`
and `make_eval_step` move the model to the card unless the caller passes
`device="cpu"`.  A train step takes a uint8 batch [B, H, W, C] and its labels
[B, H, W], normalizes on that device, runs the model's train forward
(channel-major logits; BatchNorm updates its running statistics as it
goes), the segmentation loss, the backward, and one optimizer update at the
scheduled lr.  The eval step returns the batch's confusion matrix on the
device; only that [C, C] matrix crosses to the host.

The optimizers are optax's of the JAX package, written as torch's:
`sgd` is optax's `add_decayed_weights` -> `sgd(momentum, nesterov=False)`
chain, which is torch's SGD with `weight_decay` (the decay is added to the
gradient before the momentum trace, for every parameter, BatchNorm and
PReLU included); `adam` is optax's `adamw` (b1 0.9, b2 0.999, eps 1e-8,
decoupled decay), which is torch's AdamW.  Update n runs at
`schedule(n)`, n the updates already made (optax's count).

With `augment=True` a step first runs the train-time transforms on its
device (`data/transforms.py::train_transform`: normalize, then the fused
scale / crop / flip to `crop_hw`), drawing from a torch.Generator made
per global step (`step_generator(seed, step)`, the counterpart of the
reference's `fold_in(key, step)`), so that a step's crops do not depend
on what ran before it.

`train_segmentation` is the epoch loop: per epoch the loader's epoch
pinned, its batches, the val mIoU, the best mIoU and a history line, with
`max_steps` as a hard stop.  Checkpoints (`ckpt_dir`, `resume`,
`ckpt_every_steps`: ROADMAP A.3), the device mesh (A.6), `remat` and
`bn_groups` (A.7) belong to later slices of the port and raise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from mspl_tpu_torch.data.transforms import normalize, train_transform
from mspl_tpu_torch.engine.losses import segmentation_loss
from mspl_tpu_torch.engine.metrics import MIOU, confusion_matrix
from mspl_tpu_torch.engine.schedules import Schedule, build_schedule
from mspl_tpu_torch.pseudo.generate import load_variables
from mspl_tpu_torch.utils.tb_logger import ScalarLogger

_LATER = "belongs to a later slice of the PyTorch port (ROADMAP {})"


def build_optimizer(name: str, params: Iterable[torch.Tensor],
                    schedule: Schedule, momentum: float = 0.9,
                    weight_decay: float = 4e-5) -> torch.optim.Optimizer:
    """`sgd` or `adam` (AdamW) over `params`, starting at `schedule(0)`."""
    if name == "sgd":
        return torch.optim.SGD(params, lr=schedule(0), momentum=momentum,
                               weight_decay=weight_decay, nesterov=False)
    if name == "adam":
        return torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer '{name}'")


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and
    the lr schedule, and the count of updates made."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0


def create_train_state(model: nn.Module, optimizer: str, schedule: Schedule,
                       momentum: float = 0.9, weight_decay: float = 4e-5,
                       device="cuda") -> TrainState:
    """The state of `model`, moved to `device`, and its optimizer."""
    model.to(device)
    return TrainState(model, build_optimizer(
        optimizer, model.parameters(), schedule, momentum, weight_decay),
        schedule)


def _on(batch: Dict, key: str, device: torch.device):
    v = batch.get(key)
    return None if v is None else torch.as_tensor(v).to(device)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of global step `step` of a run seeded `seed`."""
    return torch.Generator().manual_seed(seed * 2 ** 32 + step)


def make_train_step(model: nn.Module, class_weights=None,
                    reg_mode: str = "none", reg_weight: float = 0.0,
                    augment: bool = False,
                    crop_hw: Optional[Tuple[int, int]] = None,
                    scale_range: Tuple[float, float] = (0.5, 2.0),
                    device="cuda"):
    """Returns `step(state, batch, rng=None) -> (state, {"loss"})` for
    `model`, which moves to `device`.

    `batch`: "image" uint8 [B, H, W, C], "label" [B, H, W] and optionally
    "valid" [B] (rows that count), numpy arrays or tensors on any device.
    With `augment`, the step crops to `crop_hw` at scales in `scale_range`
    with draws from `rng` (a torch.Generator; by default
    `step_generator(0, state.step)`).  The loss is the segmentation loss
    over the model's channel-major logits; the returned loss is a 0-d f32
    tensor on `device`."""
    if augment and crop_hw is None:
        raise ValueError("augment=True needs crop_hw")
    device = torch.device(device)
    model.to(device)
    cw = (None if class_weights is None else
          torch.as_tensor(np.asarray(class_weights, np.float32),
                          device=device))

    def step(state: TrainState, batch: Dict,
             rng: Optional[torch.Generator] = None):
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        model.train()
        imgs, labels = _on(batch, "image", device), _on(batch, "label",
                                                        device)
        if augment:
            imgs, labels = train_transform(
                imgs, labels, crop_hw,
                rng if rng is not None else step_generator(0, state.step),
                scale_range)
        else:
            imgs = normalize(imgs)
        logits = model(imgs)
        loss = segmentation_loss(
            logits, labels, class_weights=cw, reg_mode=reg_mode,
            reg_weight=reg_weight, batch_mask=_on(batch, "valid", device))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


def make_eval_step(model: nn.Module, num_classes: int, device="cuda"):
    """Returns `step(batch) -> confusion matrix` (float32 [C, C] on
    `device`, rows = ground truth) of `model`'s eval forward; the model
    moves to `device`."""
    device = torch.device(device)
    model.to(device)

    def step(batch: Dict) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            out = model(normalize(_on(batch, "image", device)))
            return confusion_matrix(out.argmax(1), _on(batch, "label", device),
                                    num_classes,
                                    batch_mask=_on(batch, "valid", device))

    return step


def evaluate(eval_step, loader: Iterable[Dict],
             num_classes: int) -> Tuple[np.ndarray, float]:
    """Run the eval loop; returns (per-class IoU, mIoU)."""
    miou = MIOU(num_classes)
    for batch in loader:
        miou.update(eval_step(batch))
    return miou.get_iou()


@dataclass
class TrainLoopConfig:
    epochs: int = 50
    crop_hw: Tuple[int, int] = (256, 256)
    scale_range: Tuple[float, float] = (0.5, 2.0)
    lr: float = 0.009
    scheduler: str = "hybrid"
    optimizer: str = "sgd"
    momentum: float = 0.9
    weight_decay: float = 4e-5
    reg_mode: str = "none"
    reg_weight: float = 0.0
    seed: int = 0
    ckpt_dir: Optional[str] = None    # checkpoints: ROADMAP A.3
    log_dir: Optional[str] = None
    resume: bool = False              # A.3
    eval_every: int = 1
    augment: bool = True
    remat: bool = False               # A.7
    verbose: bool = True
    ckpt_every_steps: int = 0         # A.3
    # hard stop after N optimizer steps
    max_steps: Optional[int] = None
    bn_groups: int = 1                # A.7


def train_segmentation(
    model: nn.Module,
    variables,
    train_loader,
    val_loader,
    num_classes: int,
    cfg: TrainLoopConfig,
    class_weights: Optional[np.ndarray] = None,
    mesh=None,
    device="cuda",
) -> Dict[str, Any]:
    """The training loop: per epoch the train steps, the val mIoU and the
    best mIoU.  `variables` (a flax tree of numpy arrays or a state dict;
    None keeps the model's weights) are loaded into `model`, which moves
    to `device` and is trained in place.  Returns {'state', 'best_miou',
    'history'}."""
    if mesh is not None:
        raise NotImplementedError(f"a device mesh {_LATER.format('A.6')}")
    if cfg.ckpt_dir or cfg.resume or cfg.ckpt_every_steps:
        raise NotImplementedError(
            f"checkpoints (ckpt_dir, resume, ckpt_every_steps) "
            f"{_LATER.format('A.3')}")
    if cfg.remat or cfg.bn_groups != 1:
        raise NotImplementedError(
            f"remat (activation checkpointing) and bn_groups (ghost-batch "
            f"statistics) {_LATER.format('A.7')}")
    if variables is not None:
        load_variables(model, variables)
    steps_per_epoch = max(len(train_loader), 1)
    schedule = build_schedule(cfg.scheduler, cfg.lr,
                              cfg.epochs * steps_per_epoch,
                              steps_per_epoch=steps_per_epoch)
    state = create_train_state(model, cfg.optimizer, schedule, cfg.momentum,
                               cfg.weight_decay, device=device)
    train_step = make_train_step(
        model, class_weights=class_weights, reg_mode=cfg.reg_mode,
        reg_weight=cfg.reg_weight, augment=cfg.augment, crop_hw=cfg.crop_hw,
        scale_range=cfg.scale_range, device=device)
    eval_step = make_eval_step(model, num_classes, device=device)
    logger = ScalarLogger(cfg.log_dir)
    best_miou = -1.0
    history = []
    stopped = False

    for epoch in range(cfg.epochs):
        t0 = time.time()
        losses = []
        # the loader's shuffle order is a function of seed + epoch
        train_loader.epoch = epoch
        batches = (train_loader.iter_batches(0)
                   if hasattr(train_loader, "iter_batches")
                   else train_loader)
        for b, batch in enumerate(batches):
            step_i = epoch * steps_per_epoch + b
            state, metrics = train_step(state, batch,
                                        step_generator(cfg.seed, step_i))
            losses.append(metrics["loss"])
            if cfg.max_steps is not None and step_i + 1 >= cfg.max_steps:
                stopped = True
                break
        if stopped:
            break
        mean_loss = (float(np.mean(torch.stack(losses).cpu().numpy()))
                     if losses else 0.0)
        lr_now = float(schedule((epoch + 1) * steps_per_epoch))
        logger.add_scalar("train/loss", mean_loss, epoch)
        logger.add_scalar("train/lr", lr_now, epoch)

        miou = None
        if val_loader is not None and (epoch + 1) % cfg.eval_every == 0:
            _, miou = evaluate(eval_step, val_loader, num_classes)
            logger.add_scalar("val/miou", miou, epoch)
        is_best = miou is not None and miou > best_miou
        if is_best:
            best_miou = miou
        history.append({"epoch": epoch, "loss": mean_loss, "miou": miou,
                        "lr": lr_now, "sec": time.time() - t0})
        if cfg.verbose:
            print(f"epoch {epoch}: loss {mean_loss:.4f} lr {lr_now:.5f}"
                  + (f" val mIoU {miou:.4f}{' *' if is_best else ''}"
                     if miou is not None else ""), flush=True)

    logger.close()
    return {"state": state, "best_miou": best_miou, "history": history}
