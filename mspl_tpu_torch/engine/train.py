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
`max_steps` as a hard stop.  With `ckpt_dir` it writes the train state
after every epoch (and the best one), and every `ckpt_every_steps` steps
within an epoch; `resume` restores the last one, mid-epoch at the recorded
step, as the reference does.  The state is written in the layout of the
JAX package's flax `TrainState` (`train_state_tree`), so either package
resumes from the other's checkpoint: SGD's momentum buffer is optax's
`trace` (no buffer yet is a zero trace: both take the same first step),
AdamW's `exp_avg`/`exp_avg_sq` are `mu`/`nu`, and its step and the
schedule's are optax's counts.

`bn_groups` > 1 runs the step's forward and backward under
`bn_stat_groups` (`layers/conv_blocks.py`): every BatchNorm of the model
takes ghost-batch statistics over B / bn_groups samples.  `remat`
checkpoints the forward (`torch.utils.checkpoint`, as the reference wraps
it in `jax.checkpoint`): the backward recomputes the activations from the
normalized batch instead of holding them.  The recompute runs under
`frozen_bn_stats`, so the running statistics move once a step, and under
the step's group count; it draws no random numbers (the segmentation
forward has no dropout, and the crops are drawn before it), so the
recomputed activations are the forward's and the step's numbers do not
change.  Kernel ③ launches again in the recompute.

Under a mesh (`parallel/mesh.py`; `make_train_step(mesh=)`,
`evaluate(mesh=)`, `train_segmentation(mesh=)`) each rank takes its data
slice of every global batch, the crops drawn for the global batch (so a
rank's are the single-device run's), BatchNorm over the global batch
(`bn_sync`), the loss over the global batch's valid pixels, and the
gradients summed over the data axis in one flat bucket a dtype before the
optimizer step; the state is replicated at the start and stays equal on
every rank, so the step is the single-device step on the global batch up
to rounding.  Model slices of the mesh are replicas of one another.  Only
the mesh's first rank logs and writes checkpoints; every rank resumes from
the same file; ranks outside the mesh receive the trained weights.  With
`torch.distributed` initialized and no mesh given, `train_segmentation`
takes `make_mesh_for_batch(train_loader.batch_size)`, as the reference
defaults to a mesh over every device; one process trains alone.

On a CUDA device, without a mesh and without `remat`, the model's train
forward and its backward replay from CUDA graphs (`ops/graphs.py`), so
that the host issues a few launches a step instead of thousands: two
graphs a key (the augmented batch's shape and dtype, and whether the batch
has "valid"), joined as one autograd node the way
`torch.cuda.make_graphed_callables` joins them (`_Replayed`).  The forward
graph runs the model on the normalized crops to the logits, BatchNorm's
running-statistic updates and ③'s launches included; the backward graph
runs from the logits' gradient to every parameter's, ③'s plain backward
included, and autograd then accumulates those into `.grad`.  The upload,
the augmentation (whose scale draw moves its shapes each step),
`segmentation_loss`, the backward down to the logits and the optimizer
step stay eager.  A key's first step runs eagerly, which warms cuDNN,
cuBLAS, ③'s plans and the optimizer's buffers; its second captures both
graphs (a capture runs no kernel, so it leaves the train state as it was)
and replays them at once; every later step replays.  The replay is issued
from inside the model's own call, so hooks on the model still bracket it.
When the storage of any parameter or buffer changes (a restore that
replaces tensors, `model.to`), the graphs go: a key's next step runs
eagerly, and the one after captures again.  Under a mesh the gradients'
`all_reduce` keeps the step eager; with `remat` the recompute does.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from mspl_tpu_torch.data.transforms import normalize, train_transform
from mspl_tpu_torch.engine.losses import segmentation_loss
from mspl_tpu_torch.engine.metrics import MIOU, confusion_matrix
from mspl_tpu_torch.engine.schedules import Schedule, build_schedule
from mspl_tpu_torch.layers.conv_blocks import (bn_stat_groups, bn_sync,
                                               frozen_bn_stats)
from mspl_tpu_torch.ops import graphs
from mspl_tpu_torch.parallel.mesh import (barrier, make_mesh_for_batch, psum,
                                          replicate, shard_batch,
                                          share_with_outside)
from mspl_tpu_torch.utils.checkpoint import (has_checkpoint, load_checkpoint,
                                             save_checkpoint)
from mspl_tpu_torch.utils.flax_bridge import (flax_variables,
                                              load_flax_variables,
                                              load_variables, to_flax,
                                              to_port)
from mspl_tpu_torch.utils.print_utils import (print_info_message,
                                              print_log_message)
from mspl_tpu_torch.utils.profiling import span
from mspl_tpu_torch.utils.tb_logger import ScalarLogger

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


def _buffers(state: TrainState, name: str) -> Dict[str, torch.Tensor]:
    """{parameter key: the optimizer's `name` buffer} where it has one."""
    opt = state.optimizer
    return {k: opt.state[p][name] for k, p in state.model.named_parameters()
            if name in opt.state.get(p, {})}


def _params_tree(state: TrainState, tensors) -> Dict:
    return to_flax(state.model, tensors, ("params",))["params"]


def train_state_tree(state: TrainState) -> Dict[str, Any]:
    """The state as the JAX package's flax `TrainState` serializes it:
    {step, params, opt_state, batch_stats}, nested dicts of numpy arrays,
    the optimizer state in optax's layout (sgd: `add_decayed_weights`
    then `sgd`; adam: `adamw`)."""
    variables = flax_variables(state.model)
    count = np.asarray(state.step, np.int32)
    if isinstance(state.optimizer, torch.optim.AdamW):
        opt_state = {"0": {"count": count,
                           "mu": _params_tree(state, _buffers(state,
                                                              "exp_avg")),
                           "nu": _params_tree(state, _buffers(
                               state, "exp_avg_sq"))},
                     "1": {}, "2": {"count": count}}
    elif isinstance(state.optimizer, torch.optim.SGD):
        opt_state = {"0": {}, "1": {
            "0": {"trace": _params_tree(state, _buffers(state,
                                                        "momentum_buffer"))},
            "1": {"count": count}}}
    else:
        raise TypeError(f"no flax layout for {type(state.optimizer)}")
    return {"step": count if state.step else 0,
            "params": variables["params"], "opt_state": opt_state,
            "batch_stats": variables["batch_stats"]}


def restore_train_state(state: TrainState, tree) -> TrainState:
    """Load a `train_state_tree` (written by either package) into `state`
    in place: the model's parameters and statistics, the optimizer's
    buffers and the step count."""
    model, opt = state.model, state.optimizer
    load_flax_variables(model, tree)
    step = int(np.asarray(tree["step"]))
    opt_state = tree["opt_state"]
    opt.state.clear()
    params = dict(model.named_parameters())
    if step and isinstance(opt, torch.optim.AdamW):
        adam = opt_state["0"]
        mu = to_port(model, {"params": adam["mu"]}, ("params",))
        nu = to_port(model, {"params": adam["nu"]}, ("params",))
        for k, p in params.items():
            opt.state[p] = {
                "step": torch.tensor(float(np.asarray(adam["count"])),
                                     dtype=torch.float32),
                "exp_avg": mu[k].to(p.device),
                "exp_avg_sq": nu[k].to(p.device)}
    elif step and isinstance(opt, torch.optim.SGD):
        trace = to_port(model, {"params": opt_state["1"]["0"]["trace"]},
                        ("params",))
        for k, p in params.items():
            opt.state[p] = {"momentum_buffer": trace[k].to(p.device)}
    state.step = step
    return state


def _on(batch: Dict, key: str, device: torch.device):
    v = batch.get(key)
    return None if v is None else torch.as_tensor(v).to(device)


def _norm_kw(mean, std) -> Dict:
    """`normalize`'s statistics where the caller gives them, as the
    reference's steps pass them."""
    kw = {}
    if mean is not None:
        kw["mean"] = mean
    if std is not None:
        kw["std"] = std
    return kw


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of global step `step` of a run seeded `seed`."""
    return torch.Generator().manual_seed(seed * 2 ** 32 + step)


@contextlib.contextmanager
def _bn_context(groups: int, sync):
    """The step's BatchNorm statistics: `groups` ghost-batch groups of the
    global batch, and with `sync` (group, D) its split over a data axis."""
    with bn_stat_groups(groups), bn_sync(*(sync or (None, 1))):
        yield


def _remat_context(groups: int, sync):
    """`torch.utils.checkpoint`'s contexts: none around the forward (the
    step's own BatchNorm contexts hold there), the step's and frozen
    running statistics around the recompute, which may run in autograd's
    device thread."""
    @contextlib.contextmanager
    def recompute():
        with _bn_context(groups, sync), frozen_bn_stats():
            yield
    return lambda: (contextlib.nullcontext(), recompute())


def data_axis(mesh):
    """(the data axis's process group, and the (group, D) that `bn_sync`
    takes where D > 1, else None); (None, None) without a mesh."""
    if mesh is None:
        return None, None
    group, d = mesh.group("data"), mesh.shape["data"]
    return group, ((group, d) if d > 1 else None)


def data_rows(batch: Dict, mesh) -> Tuple[Dict, Optional[Tuple[int, int]]]:
    """(this rank's slice of the global `batch`, (its first row, the
    global batch size)); the batch as it is and None without a mesh."""
    if mesh is None:
        return batch, None
    total = len(batch["image"])
    local = shard_batch(batch, mesh)
    return local, (mesh.index("data") * len(local["image"]), total)


def sum_grads(params: Iterable[torch.Tensor], group) -> None:
    """Sum the parameters' gradients over the ranks of `group`, in place:
    one `all_reduce` of a flat bucket a dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        if group is not None:
            dist.all_reduce(flat, group=group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


@dataclass
class _StepReplay:
    """A key's captured train forward and backward: the two graphs (the
    forward's output the logits, the backward's the parameters' gradients,
    None where a parameter takes none), the input each forward replay
    reads, the logits' gradient each backward replay reads and the
    parameters."""

    forward: graphs.Captured
    backward: graphs.Captured
    input: torch.Tensor
    grad_output: torch.Tensor
    params: Tuple[torch.Tensor, ...]


class _Replayed(torch.autograd.Function):
    """The model's forward as one autograd node: its forward replays the
    forward graph on `x`, its backward the backward graph, and autograd
    accumulates the parameters' gradients it returns into `.grad`."""

    @staticmethod
    def forward(ctx, rep: _StepReplay, x, *params):
        ctx.rep = rep
        rep.input.copy_(x)
        with span("mspl.train.replay"):
            out = rep.forward.replay()
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        rep = ctx.rep
        rep.grad_output.copy_(grad)
        grads = rep.backward.replay()
        return (None, None) + tuple(None if g is None else g.detach()
                                    for g in grads)


@contextlib.contextmanager
def _forward_as(model: nn.Module, fn: Callable):
    """`model`'s forward replaced by `fn` for the block, so that a call of
    the model, hooks and all, runs `fn`."""
    own = vars(model).get("forward")
    model.forward = fn
    try:
        yield
    finally:
        if own is None:
            del model.forward
        else:
            model.forward = own


class _ModelGraphs:
    """The train step's CUDA graphs of `model`'s forward and backward, a
    pair a key, in one memory pool (module docstring); `counts` (the step)
    holds the counters `graph_captures`, `graph_replays` and
    `eager_steps`."""

    def __init__(self, model: nn.Module, counts):
        self.model, self.counts = model, counts
        self.replays: Dict[tuple, _StepReplay] = {}
        self.seen = set()  # keys whose step ran eagerly once
        self.pool = graphs.Pool()
        self.storage = None

    def watch(self) -> None:
        """Drop the graphs if the storage of a parameter or buffer changed
        since the last step.  A step calls this before its upload, while
        the card still runs the step before."""
        storage = (tuple((p.data_ptr(), p.requires_grad)
                         for p in self.model.parameters()),
                   tuple(b.data_ptr() for b in self.model.buffers()))
        if storage != self.storage:
            self.replays.clear()
            self.seen.clear()
            self.storage = storage

    def __call__(self, x: torch.Tensor, masked: bool) -> torch.Tensor:
        """The model's logits on `x`: eager on a key's first step,
        captured on its second, replayed from then on."""
        key = (tuple(x.shape), x.dtype, masked)
        if key not in self.replays and key not in self.seen:
            self.seen.add(key)
            self.counts.eager_steps += 1
            return self.model(x)
        orig = self.model.forward
        with _forward_as(self.model, lambda x: self._replay(key, x, orig)):
            return self.model(x)

    def _replay(self, key: tuple, x: torch.Tensor,
                orig: Callable) -> torch.Tensor:
        rep = self.replays.get(key)
        if rep is None:
            rep = self.replays[key] = self._capture(x, orig)
            self.counts.graph_captures += 1
        self.counts.graph_replays += 1
        return _Replayed.apply(rep, x, *rep.params)

    def _capture(self, x: torch.Tensor, orig: Callable) -> _StepReplay:
        """Capture `orig`, the model's forward, on a copy of `x`, then its
        backward from the logits to every parameter that takes a
        gradient, into the step's pool."""
        params = tuple(p for p in self.model.parameters() if p.requires_grad)
        static = x.detach().clone()
        fwd = self.pool.capture(lambda: orig(static), graphs.kept(self.model))
        out = fwd.output
        fwd.output = out.detach()  # the backward capture consumes `out`
        grad_out = torch.empty_like(out)
        bwd = self.pool.capture(lambda: torch.autograd.grad(
            out, params, grad_out, allow_unused=True))
        return _StepReplay(fwd, bwd, static, grad_out, params)


def make_train_step(model: nn.Module,
                    crop_hw: Optional[Tuple[int, int]] = None,
                    scale_range: Tuple[float, float] = (0.5, 2.0),
                    class_weights=None, reg_mode: str = "none",
                    reg_weight: float = 0.0, augment: bool = True,
                    mean=None, std=None, remat: bool = False,
                    bn_groups: int = 1, *, device="cuda", mesh=None):
    """Returns `step(state, batch, rng=None) -> (state, {"loss"})` for
    `model`, which moves to `device`.  The parameters, their order and
    their defaults are the reference's, less its JAX-only `donate` and
    `packer`, plus the port's `device` and `mesh`.

    `batch`: "image" uint8 [B, H, W, C], "label" [B, H, W] and optionally
    "valid" [B] (rows that count), numpy arrays or tensors on any device.
    With `augment`, the step crops to `crop_hw` at scales in `scale_range`
    with draws from `rng` (a torch.Generator; by default
    `step_generator(0, state.step)`).  `mean`/`std` replace the ImageNet
    statistics of `normalize` where given.  `remat` recomputes the
    forward's activations in the backward; `bn_groups` > 1 takes ghost-
    batch BatchNorm statistics (module docstring).  The loss is the
    segmentation loss over the model's channel-major logits; the returned
    loss is a 0-d f32 tensor on `device`.

    With `mesh`, `batch` is the global batch, the same on every rank of
    the mesh: the step takes this rank's data slice of it and runs the
    module docstring's data-parallel step; the loss returned is the
    global batch's.  `bn_groups` > 1 must then be a multiple of the data
    axis.

    On a CUDA device, without `mesh` and `remat`, the model's forward and
    backward replay from CUDA graphs from a key's second step on (module
    docstring).  The step's `graph_captures`, `graph_replays` and
    `eager_steps` count its steps by how the model ran.

    Under a profiler each phase of the step is a span: `mspl.train.upload`,
    `.augment`, `.forward` (with `.replay` inside it around a forward
    graph's replay), `.loss`, `.backward` and `.optimizer`
    (`utils/profiling.py`)."""
    if augment and crop_hw is None:
        raise ValueError("augment=True needs crop_hw")
    group, sync = data_axis(mesh)
    forward = model
    if remat:
        context_fn = _remat_context(bn_groups, sync)

        def forward(x):
            return checkpoint(model, x, use_reentrant=False,
                              context_fn=context_fn)
    device = torch.device(device)
    model.to(device)
    cw = (None if class_weights is None else
          torch.as_tensor(np.asarray(class_weights, np.float32),
                          device=device))
    norm_kw = _norm_kw(mean, std)

    def step(state: TrainState, batch: Dict,
             rng: Optional[torch.Generator] = None):
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        model.train()
        if model_graphs is not None:
            model_graphs.watch()
        batch, rows = data_rows(batch, mesh)
        with span("mspl.train.upload"):
            imgs = _on(batch, "image", device)
            labels = _on(batch, "label", device)
            valid = _on(batch, "valid", device)
        with span("mspl.train.augment"):
            if augment:
                draws = rng if rng is not None else step_generator(
                    0, state.step)
                imgs, labels = train_transform(imgs, labels, crop_hw, draws,
                                               scale_range, rows=rows,
                                               **norm_kw)
            else:
                imgs = normalize(imgs, **norm_kw)
        state.optimizer.zero_grad(set_to_none=True)
        with _bn_context(bn_groups, sync):
            with span("mspl.train.forward"):
                if model_graphs is not None and graphs.graphable(imgs):
                    logits = model_graphs(imgs, valid is not None)
                else:
                    step.eager_steps += 1
                    logits = forward(imgs)
            with span("mspl.train.loss"):
                loss = segmentation_loss(
                    logits, labels, class_weights=cw, reg_mode=reg_mode,
                    reg_weight=reg_weight, batch_mask=valid, group=group)
            with span("mspl.train.backward"):
                loss.backward()
                if mesh is not None:
                    sum_grads(model.parameters(), group)
        loss = loss.detach()
        if mesh is not None:
            loss = psum(loss.clone(), mesh)
        with span("mspl.train.optimizer"):
            lr = state.schedule(state.step)
            for pg in state.optimizer.param_groups:
                pg["lr"] = lr
            state.optimizer.step()
        state.step += 1
        return state, {"loss": loss}

    step.graph_captures = step.graph_replays = step.eager_steps = 0
    model_graphs = (None if mesh is not None or remat
                    else _ModelGraphs(model, step))
    return step


def make_eval_step(model: nn.Module, num_classes: int, mean=None, std=None,
                   *, device="cuda"):
    """Returns `step(batch) -> confusion matrix` (float32 [C, C] on
    `device`, rows = ground truth) of `model`'s eval forward, the batch
    normalized with `mean`/`std` where given; the model moves to
    `device`."""
    device = torch.device(device)
    model.to(device)
    norm_kw = _norm_kw(mean, std)

    def step(batch: Dict) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            out = model(normalize(_on(batch, "image", device), **norm_kw))
            return confusion_matrix(out.argmax(1), _on(batch, "label", device),
                                    num_classes,
                                    batch_mask=_on(batch, "valid", device))

    return step


def evaluate(eval_step, loader: Iterable[Dict], num_classes: int,
             mesh=None) -> Tuple[np.ndarray, float]:
    """Run the eval loop; returns (per-class IoU, mIoU).  With `mesh`,
    each rank of the mesh evaluates its data slice of every batch and the
    confusion matrices are summed over the data axis, so every rank
    returns the whole set's."""
    miou = MIOU(num_classes)
    for batch in loader:
        if mesh is None:
            miou.update(eval_step(batch))
        else:
            miou.update(psum(eval_step(shard_batch(batch, mesh)).clone(),
                             mesh))
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
    ckpt_dir: Optional[str] = None
    log_dir: Optional[str] = None
    resume: bool = False
    eval_every: int = 1
    augment: bool = True
    remat: bool = False
    verbose: bool = True
    # also checkpoint every N optimizer steps within an epoch (0: per epoch
    # only); `resume` re-enters the epoch at the recorded step
    ckpt_every_steps: int = 0
    # hard stop after N optimizer steps
    max_steps: Optional[int] = None
    bn_groups: int = 1


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
    to `device` and is trained in place.  With `mesh`, every rank of the
    job runs this call with the same loaders and mesh (module docstring);
    each ends with the same weights and result.  Returns {'state',
    'best_miou', 'history'}."""
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
    first = mesh is None or mesh.is_first

    start_epoch, start_step_in_epoch, best_miou = 0, 0, -1.0
    if cfg.resume and cfg.ckpt_dir and has_checkpoint(cfg.ckpt_dir):
        tree, meta = load_checkpoint(cfg.ckpt_dir)
        restore_train_state(state, tree)
        ck_epoch = int(meta.get("epoch", 0))
        sie = int(meta.get("step_in_epoch", 0))
        best_miou = float(meta.get("best_miou", -1.0))
        if 0 < sie < steps_per_epoch:
            # mid-epoch checkpoint: re-enter the same epoch at the recorded
            # batch; the loader's order is a function of seed + epoch, so
            # the remaining batches are the same
            start_epoch, start_step_in_epoch = ck_epoch, sie
            msg = (f"resumed mid-epoch {ck_epoch} at step {sie}, "
                   f"best mIoU {best_miou:.4f}")
        else:
            start_epoch = ck_epoch + 1
            msg = (f"resumed from epoch {ck_epoch}, "
                   f"best mIoU {best_miou:.4f}")
        if first:
            print_info_message(msg)
    history = []
    if mesh is not None:
        replicate(model, mesh)
    if mesh is None or mesh.coords is not None:
        best_miou = _epochs(state, train_loader, val_loader, num_classes,
                            cfg, class_weights, mesh, device, first,
                            start_epoch, start_step_in_epoch, best_miou,
                            history)
    best_miou, history, state.step = share_with_outside(
        model, mesh, (best_miou, history, state.step))
    if mesh is not None:
        barrier()
    return {"state": state, "best_miou": best_miou, "history": history}


def _epochs(state, train_loader, val_loader, num_classes, cfg, class_weights,
            mesh, device, first, start_epoch, start_step_in_epoch,
            best_miou, history) -> float:
    """`train_segmentation`'s epochs on a rank of the mesh (or alone):
    appends to `history`, returns the best mIoU."""
    model, schedule = state.model, state.schedule
    steps_per_epoch = max(len(train_loader), 1)
    train_step = make_train_step(
        model, class_weights=class_weights, reg_mode=cfg.reg_mode,
        reg_weight=cfg.reg_weight, augment=cfg.augment, crop_hw=cfg.crop_hw,
        scale_range=cfg.scale_range, remat=cfg.remat,
        bn_groups=cfg.bn_groups, device=device, mesh=mesh)
    eval_step = make_eval_step(model, num_classes, device=device)
    logger = ScalarLogger(cfg.log_dir if first else None)

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        losses = []
        # the loader's shuffle order is a function of seed + epoch
        train_loader.epoch = epoch
        skip = start_step_in_epoch if epoch == start_epoch else 0
        batches = (train_loader.iter_batches(skip)
                   if hasattr(train_loader, "iter_batches")
                   else train_loader)
        stopped = False
        for b, batch in enumerate(batches, start=skip):
            step_i = epoch * steps_per_epoch + b
            state, metrics = train_step(state, batch,
                                        step_generator(cfg.seed, step_i))
            losses.append(metrics["loss"])
            done_in_epoch = b + 1
            if (cfg.ckpt_every_steps and cfg.ckpt_dir and first
                    and done_in_epoch < steps_per_epoch
                    and done_in_epoch % cfg.ckpt_every_steps == 0):
                save_checkpoint(
                    cfg.ckpt_dir, train_state_tree(state),
                    {"epoch": epoch, "step_in_epoch": done_in_epoch,
                     "best_miou": best_miou})
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
            _, miou = evaluate(eval_step, val_loader, num_classes, mesh)
            logger.add_scalar("val/miou", miou, epoch)
        is_best = miou is not None and miou > best_miou
        if is_best:
            best_miou = miou
        if cfg.ckpt_dir and first:
            save_checkpoint(
                cfg.ckpt_dir, train_state_tree(state),
                {"epoch": epoch, "best_miou": best_miou,
                 "miou": miou if miou is not None else -1.0},
                is_best=is_best)
        history.append({"epoch": epoch, "loss": mean_loss, "miou": miou,
                        "lr": lr_now, "sec": time.time() - t0})
        if cfg.verbose and first:
            print_log_message(
                f"epoch {epoch}: loss {mean_loss:.4f} lr {lr_now:.5f}"
                + (f" val mIoU {miou:.4f}{' *' if is_best else ''}"
                   if miou is not None else ""))

    logger.close()
    return best_miou
