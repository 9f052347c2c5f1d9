"""Train and eval steps (port of mspl_tpu/engine/train.py:
`build_optimizer`, `make_train_step(augment=False)`, `make_eval_step`,
`evaluate`).

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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn as nn

from mspl_tpu_torch.data.transforms import normalize
from mspl_tpu_torch.engine.losses import segmentation_loss
from mspl_tpu_torch.engine.metrics import MIOU, confusion_matrix
from mspl_tpu_torch.engine.schedules import Schedule


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


def make_train_step(model: nn.Module, class_weights=None,
                    reg_mode: str = "none", reg_weight: float = 0.0,
                    augment: bool = False, device="cuda"):
    """Returns `step(state, batch) -> (state, {"loss"})` for `model`, which
    moves to `device`.

    `batch`: "image" uint8 [B, H, W, C], "label" [B, H, W] and optionally
    "valid" [B] (rows that count), numpy arrays or tensors on any device.
    The loss is the segmentation loss over the model's channel-major
    logits; the returned loss is a 0-d f32 tensor on `device`."""
    if augment:
        raise NotImplementedError(
            "augment=True needs the train-side transforms (train_transform), "
            "which the data slice of the port brings; pass augment=False")
    device = torch.device(device)
    model.to(device)
    cw = (None if class_weights is None else
          torch.as_tensor(np.asarray(class_weights, np.float32),
                          device=device))

    def step(state: TrainState, batch: Dict):
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        model.train()
        logits = model(normalize(_on(batch, "image", device)))
        loss = segmentation_loss(
            logits, _on(batch, "label", device), class_weights=cw,
            reg_mode=reg_mode, reg_weight=reg_weight,
            batch_mask=_on(batch, "valid", device))
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
