"""The self-training fine-tune, timed for a window of seconds.

Set-up makes a pool of seeded uint8 images with labels in {0, 1, 2}, most
pixels ignored as a round's thresholded pseudo-labels are, the class
weights from the labels' histogram, and the cell's model with weights from
the seed.  Then one call of the port's
`engine/train.py::train_segmentation` runs everything: its first steps (the
checked ones), its warm steps and the window.  The benchmark's loader
serves the port's `DataLoader`'s shuffled batches and ends the run when
the window's seconds have passed, so set-up and window drive the same
train state, optimizer and step.

The first `check_steps` steps are the comparison's: the loss of each (the
program's `segmentation_loss` is wrapped for them), the momentum buffers
after the first optimizer step (grad + weight decay x parameter), and the
parameters as the loader hands over the next batch.  A CUDA event recorded
as the loader hands over batch k + 1 follows step k on the stream, so the
interval between consecutive marks is a step's time to completion.

After the window the program is freed and the plain reference follows the
checked steps from the same weights and batches in f32.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from h100_bench import common, program
from h100_bench.reference import layers as ref_layers
from h100_bench.reference import pipeline as ref
from h100_bench.weights import make_state, shapes_of


class Labelled:
    """Pool images with their labels, served by `load_batch`."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.images)

    def load_batch(self, idx):
        return self.images[idx], self.labels[idx]


def make_pool(seed: int, tr: Dict, hw, device):
    """(images uint8 [N, H, W, 3], labels uint8 [N, H, W]): labels uniform
    over the classes, each pixel ignored with the traffic's share."""
    images = common.uint8_images(common.sub_seed(seed, 2),
                                 tr["pool_images"], hw, device)
    g = torch.Generator(device=device).manual_seed(common.sub_seed(seed, 4))
    shape = (tr["pool_images"], *hw)
    lab = torch.randint(0, tr["num_target"], shape, generator=g,
                        device=device, dtype=torch.uint8)
    ign = torch.rand(shape, generator=g, device=device) < tr["ignore_share"]
    lab = torch.where(ign, torch.full_like(lab, ref.IGNORE), lab)
    return images, lab.cpu().numpy()


def label_histogram(labels: np.ndarray, classes: int) -> np.ndarray:
    flat = labels.reshape(-1)
    return np.bincount(flat[flat != ref.IGNORE], minlength=classes)


def target_state(cell, seed, device):
    t = cell.config["target"]
    with torch.device("meta"):
        shapes = shapes_of(ref.build_model(cell.config["model"],
                                           t["classes"], torch.float32))
    return make_state(cell.config["model"]["name"], shapes,
                      common.sub_seed(seed, 1, 0), device)


class Probes:
    """What the checked steps leave: each loss, the first momentum
    buffers, the parameters after them."""

    def __init__(self, model):
        import mspl_tpu_torch.engine.train as et
        self.et, self.model = et, model
        self.losses: List[torch.Tensor] = []
        self.first_buffers: Dict[str, torch.Tensor] = {}
        self.params: Dict[str, torch.Tensor] = {}
        self.orig_loss = et.segmentation_loss
        names = {id(p): n for n, p in model.named_parameters()}

        def loss(*args, **kw):
            out = self.orig_loss(*args, **kw)
            self.losses.append(out.detach().clone())
            return out

        def after_step(opt, args, kwargs):
            # a step that made no buffer moved nothing: a zero buffer
            self.first_buffers = {
                names[id(p)]: opt.state[p].get(
                    "momentum_buffer", torch.zeros_like(p)).clone()
                for g in opt.param_groups for p in g["params"]}
            self.hook.remove()

        et.segmentation_loss = loss
        self.hook = register_optimizer_step_post_hook(after_step)

    def close(self):
        self.et.segmentation_loss = self.orig_loss
        self.params = {n: p.detach().clone()
                       for n, p in self.model.named_parameters()}


class WindowLoader:
    """`train_segmentation`'s loader: the port's loader's epochs, with the
    checked steps, the warm steps and the window counted off by batch."""

    def __init__(self, loader, window):
        self.loader, self.window = loader, window
        self.batch_size = loader.batch_size
        self.epoch = 0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return self.iter_batches()

    def iter_batches(self, start_batch: int = 0):
        if self.window.closed:
            return
        self.loader.epoch = self.epoch
        for batch in self.loader.iter_batches(start_batch):
            if not self.window.hand_over(batch):
                return
            yield batch


class Window:
    """The hand-over of batch k: the checked steps' probes, the window's
    start, its marks, the traced steps and its close."""

    def __init__(self, cell, seconds, trace, device, clock, t_start, model,
                 counters):
        tr = cell.traffic
        self.tr, self.seconds, self.trace = tr, seconds, trace
        self.device, self.clock, self.t_start = device, clock, t_start
        self.model, self.counters = model, counters
        self.k = 0
        self.first = tr["check_steps"] + tr["warm_steps"]
        self.closed = False
        self.check_idx: List[np.ndarray] = []
        self.probes = Probes(model)
        self.marks, self.view, self.prof = [], None, None

    def hand_over(self, batch) -> bool:
        from h100_bench.trace import Profiled

        k, tr = self.k, self.tr
        if k < tr["check_steps"]:
            self.check_idx.append(np.asarray(batch["index"]).copy())
        elif k == tr["check_steps"]:
            self.probes.close()
        if k == self.first:
            for fn in self.counters.values():
                fn.launches = 0
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            self.clock.sync()
            self.setup_s = time.perf_counter() - self.t_start
            self.t0 = time.perf_counter()
            self.marks.append(self.clock.mark())
        elif k > self.first:
            self.marks.append(self.clock.mark())
            if self.trace and k == self.first + tr["trace_skip"]:
                self.prof, self.traced_from = Profiled(self.device), k
                self.prof.start()
            elif self.prof is not None and (
                    k == self.first + tr["trace_skip"] + tr["trace_steps"]):
                self.stop_trace(k)
            if time.perf_counter() - self.t0 >= self.seconds:
                if self.prof is not None:
                    self.stop_trace(k)
                self.clock.sync()
                self.wall = time.perf_counter() - self.t0
                self.steps = k - self.first
                self.closed = True
                return False
        self.k += 1
        return True

    def stop_trace(self, k: int) -> None:
        self.view, self.prof = self.prof.stop(), None
        self.traced_steps = k - self.traced_from


def run(cell: common.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> common.Result:
    from mspl_tpu_torch.data.loader import DataLoader
    from mspl_tpu_torch.engine.losses import compute_class_weights
    from mspl_tpu_torch.engine.train import (TrainLoopConfig,
                                             train_segmentation)

    from h100_bench import layers_read
    from h100_bench.trace import Spans, breakdown

    tr, cfg = cell.traffic, cell.config
    classes = cfg["target"]["classes"]
    clock = common.Clock(device)
    hw = tuple(cfg["image_hw"])
    images, labels = make_pool(seed, tr, hw, device)
    cw = compute_class_weights(label_histogram(labels, classes))
    model = program.model(cfg["model"], classes, torch.float32, device,
                          cfg.get("route"))
    model.load_state_dict(target_state(cell, seed, device))
    loop_seed = common.sub_seed(seed, 5) % 2 ** 30
    loader = DataLoader(Labelled(images, labels), batch_size=tr["batch"],
                        shuffle=True, seed=loop_seed,
                        num_workers=tr["loader_workers"])
    counters = program.launch_counters(cell.launches)
    spans = Spans()
    if trace:
        spans.wrap(model, "model")
    window = Window(cell, seconds, trace, device, clock, t_start, model,
                    counters)
    tcfg = TrainLoopConfig(
        epochs=tr["epochs"], crop_hw=tuple(tr["crop_hw"]),
        scale_range=tuple(tr["scale_range"]), lr=tr["lr"],
        scheduler="poly", optimizer="sgd", momentum=tr["momentum"],
        weight_decay=tr["weight_decay"], reg_mode="kld",
        reg_weight=tr["reg_weight"], seed=loop_seed, verbose=False,
        augment=True)
    out = train_segmentation(model, None, WindowLoader(loader, window), None,
                             classes, tcfg, class_weights=cw, device=device)
    if not window.closed:
        raise RuntimeError("the fine-tune ended before the window closed: "
                           "raise the traffic's epochs")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    launches = {k: fn.launches for k, fn in counters.items()}
    spans.remove()
    step_ms = common.intervals_ms(clock, window.marks)
    steps = window.steps
    metrics = {}
    if not trace:
        metrics = {
            "train_img_per_s": {"value": steps * tr["batch"] / window.wall,
                                "unit": "img/s"},
            "train_step_ms_p95": {"value": common.p95(step_ms),
                                  "unit": "ms"},
            "setup_s": {"value": window.setup_s, "unit": "s"}}
    print(f"fine-tune window: {steps} steps, {window.wall:.3f} s, "
          f"{len(step_ms)} step intervals (median "
          f"{float(np.median(step_ms)):.3f} ms, p95 "
          f"{common.p95(step_ms):.3f} ms, longest "
          f"{common.longest(step_ms)}), set-up {window.setup_s:.3f} s, "
          f"launches {launches}", flush=True)
    reading = None
    if window.view is not None:
        reading = layers_read.Reading(
            view=window.view, units=window.traced_steps, cell=cell,
            peak_bytes=peak,
            members=[TargetMember(cfg)], hw=tuple(tr["crop_hw"]),
            batch=tr["batch"], train=True)
    prog = {"losses": [float(x) for x in window.probes.losses[:tr[
        "check_steps"]]],
        "buffers": window.probes.first_buffers,
        "params": window.probes.params}
    del out, model, window.model, window.probes.model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    steps_ref = reference_steps(cell, seed, images, labels,
                                [np.asarray(i) for i in
                                 window.check_idx], loop_seed, device)
    values = gaps(prog, steps_ref)
    print(f"readings: {json.dumps(values)}", flush=True)
    values["launch_excess"] = max(
        [abs(launches[k] - per * steps)
         for k, per in cell.launches.items()] or [0])
    checks = common.checks_from(values, cell.limits)
    res = common.Result(
        attempted=steps, metrics=metrics, checks=checks,
        memory_peak_bytes=int(peak))
    if reading is not None:
        res.metrics = layers_read.read_all(reading)
        res.busy_s = reading.view.busy_us() / 1e6
        res.window_s = reading.view.window_us / 1e6
        res.breakdown = breakdown(reading.view)
    return res


class TargetMember:
    """The fine-tuned model, as `layers_read.Reading` takes its models."""

    def __init__(self, cfg):
        self.model = cfg["model"]
        self.classes = cfg["target"]["classes"]
        self.dtype = torch.float32


# --- the reference and the comparison ---

def reference_steps(cell, seed, images, labels, batches, loop_seed, device,
                    half: bool = False, num=ref_layers.PLAIN):
    """The reference's checked steps from the same weights and batches:
    {"losses", "buffers" (after the first step), "params" (after the
    last), "init"}; `half` drops the second half of every batch (a
    fault); `num` the convolutions' numerics (the control's TF32)."""
    tr, cfg = cell.traffic, cell.config
    classes = cfg["target"]["classes"]
    model = ref.build_model(cfg["model"], classes, torch.float32, num)
    model.load_state_dict(target_state(cell, seed, device))
    model.to(device).train()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    init = {n: p.detach().clone() for n, p in zip(names, params)}
    cw = torch.as_tensor(ref.class_weights(label_histogram(labels, classes)),
                         device=device)
    total = tr["epochs"] * -(-len(images) // tr["batch"])
    bufs = [None] * len(params)
    losses, first = [], {}
    for i, idx in enumerate(batches):
        n = len(idx) // 2 if half else len(idx)
        imgs = torch.from_numpy(images[idx[:n]]).to(device)
        lab = torch.from_numpy(labels[idx[:n]].astype(np.int64)).to(device)
        draws = ref.step_draws(loop_seed, i, len(idx), images.shape[1:3],
                               tr["crop_hw"], tr["scale_range"])
        x, lab = ref.scale_crop_flip(ref.normalize(imgs), lab,
                                     tr["crop_hw"], *(d[:n] for d in draws))
        loss = ref.loss_fn(model(x), lab, cw, tr["reg_weight"])
        grads = torch.autograd.grad(loss, params)
        bufs = ref.sgd_step(params, grads, bufs,
                            ref.poly_lr(tr["lr"], total, i), tr["momentum"],
                            tr["weight_decay"])
        if i == 0:
            first = {nm: b.clone() for nm, b in zip(names, bufs)}
        losses.append(loss.item())
    return {"losses": losses, "buffers": first, "init": init,
            "params": {n: p.detach().clone() for n, p in zip(names,
                                                             params)}}


def leaf_gaps(prog: Dict, want: Dict, keep) -> List[float]:
    """Each leaf's |norm(prog) - norm(want)| over the larger of its
    reference norm and the median leaf's."""
    norms = {n: float(want[n].double().norm()) for n in keep}
    med = float(np.median(list(norms.values())))
    return [abs(float(prog[n].double().norm()) - norms[n])
            / max(norms[n], med) for n in keep]


def gaps(prog: Dict, want: Dict) -> Dict[str, float]:
    """loss_gap: the worst step's relative loss gap; grad_gap: the first
    momentum buffers' worst leaf; update_gap and update_median_gap: the
    parameters' change after the checked steps, worst and median leaf,
    leaving out the leaves whose reference gradient is under a thousandth
    of the median leaf's."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], want["losses"]))
    if len(prog["losses"]) != len(want["losses"]):
        loss_gap = float("inf")
    names = list(want["buffers"])
    g = {n: float(want["buffers"][n].double().norm()) for n in names}
    med = float(np.median(list(g.values())))
    moved = [n for n in names if g[n] >= 1e-3 * med]
    init = want["init"]
    d_prog = {n: prog["params"][n].to(init[n].device) - init[n]
              for n in moved}
    d_ref = {n: want["params"][n] - init[n] for n in moved}
    update = leaf_gaps(d_prog, d_ref, moved)
    return {"loss_gap": loss_gap,
            "grad_gap": max(leaf_gaps(prog["buffers"], want["buffers"],
                                      names)),
            "update_gap": max(update),
            "update_median_gap": float(np.median(update))}
