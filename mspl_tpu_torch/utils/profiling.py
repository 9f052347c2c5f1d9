"""Tracing and profiling utilities (port of mspl_tpu/utils/profiling.py).

* `model_parameters` / `estimate_flops`: the model card at build time (the
  reference prints the FLOPs and the parameter count of a model).
* `device_sync`: wait until the device work behind a tree of tensors is
  done, for honest timing on the host's clock.
* `StepTimer`: per-step wall-clock statistics.
* `trace`: a context manager that writes a `torch.profiler` trace of the
  code in it, which TensorBoard's profiler plugin and chrome://tracing
  read.
* `span`: the port's own named ranges, recorded only while a
  `torch.profiler` runs (its `record_function` events); otherwise one
  shared no-op context, behind a check of about 0.1 us.

The spans, each opened on the calling thread where its work happens and
none around a whole sweep or step (so that a device-idle gap is named by
the phase the host was in, not by what encloses every phase):

    mspl.loader.wait          the caller's wait for the loader's producer
                              thread (`DataLoader.iter_batches`, around
                              its queue's get only)
    mspl.generate.put         pinning a sweep's batch and issuing its
                              upload (`PseudoLabelGenerator._put`)
    mspl.generate.model:<n>   the host's issue of source <n>'s forward
                              (`batch_pass`, `model_axis_pass`)
    mspl.generate.replay:<n>  inside it, the replay of that forward's
                              CUDA graph (`PseudoLabelGenerator._forward`)
    mspl.cbst.histograms      `class_confidence_histograms`
    mspl.cbst.kc              `kc_from_histograms` (its host read)
    mspl.cbst.sweep_kc        `sweep_kc`
    mspl.cbst.apply_kc        `apply_kc_device`
    mspl.train.upload         the train step's image, label and valid
                              copies to the device
    mspl.train.augment        `train_transform` or `normalize`
    mspl.train.forward        the model's train forward
    mspl.train.replay         inside it, the replay of that forward's
                              CUDA graph (`engine/train.py`)
    mspl.train.loss           `segmentation_loss`
    mspl.train.backward       `loss.backward()` (and the gradient sum
                              under a mesh)
    mspl.train.optimizer      the learning-rate set and `optimizer.step()`
    mspl.segformer.embed:<i>  SegFormer's overlapping patch embedding of
                              stage i (1-4): its convolution and LayerNorm
    mspl.segformer.attn:<i>   a stage-i block's attention branch: its
                              LayerNorm, spatial reduction, q, kv, the two
                              products, proj and the residual add
    mspl.segformer.ffn:<i>    a stage-i block's Mix-FFN branch: its
                              LayerNorm, fc1, depthwise convolution, GELU,
                              fc2 and the residual add
    mspl.segformer.head       SegFormer's decoder: the stages' linear
                              layers, upsampling, `linear_fuse`,
                              `linear_pred` and the final resize

Wrapping a sweep or a fine-tune in `trace(dir)` records them beside the
CUDA kernels, on the profiler's one clock, so TensorBoard's trace view
shows which phase of the host each idle stretch of the card falls in:

    with profiling.trace("runs/profile"):
        gen(loader, return_device=True)

The JAX package's `start_profiler_server` has no counterpart:
`torch.profiler` has no server that a profiler client attaches to over
the network while a run goes on; wrap the steps to profile in `trace`.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Dict, Iterator, List, Mapping

import numpy as np
import torch
import torch.nn as nn
from torch.autograd.profiler import record_function

from mspl_tpu_torch.layers.stacking import flatten_tree

_OFF = contextlib.nullcontext()


def model_parameters(params) -> int:
    """Total parameter count of a module (its parameters, no buffers) or of
    a flax-layout tree of arrays (nested dicts, e.g. a variable tree's
    "params")."""
    if isinstance(params, nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    return int(sum(np.prod(np.shape(a)) for a in
                   flatten_tree(params).values()))


def estimate_flops(model: nn.Module, *inputs: torch.Tensor) -> float:
    """FLOPs of one eval forward of `model` on `inputs`, counted by
    `torch.utils.flop_counter.FlopCounterMode` (2 per multiply-add of the
    convolutions and matrix products, einsums included).

    It runs an f32 CPU copy of the model in eval mode on CPU copies of the
    inputs, so every kernel wrapper takes its plain version: the counter
    sees only PyTorch's own operators and would miss the port's CUDA
    kernels on the card.  The count depends on the shapes alone, so a bf16
    model is counted in f32, which every CPU runs at speed.  It leaves out
    elementwise work (BatchNorm, PReLU, softmax), which the JAX package's
    XLA cost analysis includes, so it reads a few percent below that
    estimate."""
    from torch.utils.flop_counter import FlopCounterMode

    twin = copy.deepcopy(model).to("cpu", torch.float32).eval()
    for mod in twin.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float32
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        twin(*(x.to("cpu", torch.float32) for x in inputs))
    return float(counter.get_total_flops())


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def device_sync(tree) -> None:
    """Wait for every CUDA device that holds a tensor of `tree` (nested
    dicts, lists and tuples of tensors) to finish its queued work:
    PyTorch returns before the device does, so a host clock read without
    this times the enqueue."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Accumulates per-step wall-clock times; `summary()` gives mean/p50/p95.

    Usage:
        timer = StepTimer()
        with timer.step():
            out = train_step(...)
            device_sync(out)
    """

    def __init__(self):
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        t = np.asarray(self.times)
        return {
            "steps": int(t.size),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "total_s": float(t.sum()),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with `torch.profiler` (host operators, and the
    CUDA kernels when a card is present) and write its trace into
    `log_dir` (`*.pt.trace.json`, TensorBoard's profiler plugin reads
    it); yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def span(name: str):
    """A `record_function` range named `name` while a `torch.profiler`
    runs, else one shared no-op context: with tracing off a span costs
    the profiler-state check and nothing more.  Names start with
    `mspl.` (module docstring)."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF
