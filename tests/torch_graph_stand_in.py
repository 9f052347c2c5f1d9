"""A CPU stand-in for the port's CUDA graph (`ops/graphs.py::CudaGraph`),
so that the CPU tests take both graph paths: the generator's capture and
replay of each source's eval forward and the train step's of the model's
train forward and backward.

`take_graph_path(monkeypatch)` turns the one switch (`graphs.graphable`)
on for CPU tensors, puts `StandInGraph` in `CudaGraph`'s place and makes
`kernel`, a kernel wrapper's stand-in, an entry of a loaded
`mspl_tpu_torch.ops` module, where `graphs` finds the wrappers that count
their launches."""

import sys
import types

import pytest
import torch

from mspl_tpu_torch.ops import graphs


def kernel(x):
    """A kernel wrapper's stand-in: counts a launch as the port's do."""
    kernel.launches += 1
    return x.clone()


kernel.launches = 0


class StandInGraph:
    """`graphs.CudaGraph` on the CPU.  A capture runs the function's Python
    once, as a CUDA capture does (the wrappers count), then puts back every
    buffer that a module's forward moved (BatchNorm's running statistics),
    since a CUDA capture runs no kernel; a capture that calls
    `torch.autograd.grad` is a backward graph and records that call.  A
    replay runs the recorded work again without moving any counter, as a
    graph's kernels run with no Python: a forward graph's into the output
    it captured, keeping its fresh autograd graph for the backward graph's
    replay, which differentiates it into the gradients it captured."""

    made = []  # every graph made since `take_graph_path`
    capturing = False

    @staticmethod
    def new_pool():
        return object()

    def __init__(self, pool):
        self.pool = pool
        self.fn = self.out = self.grad_call = self.live = None
        StandInGraph.made.append(self)

    def capture(self, fn):
        moved = {}  # id -> (buffer, its value before the capture)

        def before_forward(module, args):
            for b in module.buffers(recurse=False):
                moved.setdefault(id(b), (b, b.clone()))

        real = torch.autograd.grad

        def recording(outputs, inputs, grad_outputs=None, **kw):
            self.grad_call = (outputs, inputs, grad_outputs)
            return real(outputs, inputs, grad_outputs, **kw)

        self.fn = fn
        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            before_forward)
        StandInGraph.capturing = True
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(torch.autograd, "grad", recording)
                self.out = fn()
        finally:
            StandInGraph.capturing = False
            hook.remove()
            with torch.no_grad():
                for b, v in moved.values():
                    b.copy_(v)
        return self.out

    def replay(self):
        counters = graphs.launch_counters()
        saved = [fn.launches for fn in counters]
        try:
            if self.grad_call is None:
                with torch.enable_grad():
                    self.live = self.fn()
                with torch.no_grad():
                    self.out.copy_(self.live)
                return
            outputs, inputs, grad_outputs = self.grad_call
            fwd = next(g for g in StandInGraph.made if g.out is outputs)
            grads = torch.autograd.grad(fwd.live, inputs, grad_outputs,
                                        allow_unused=True)
            with torch.no_grad():
                for o, g in zip(self.out, grads):
                    if o is not None:
                        o.copy_(g)
        finally:
            for fn, n in zip(counters, saved):
                fn.launches = n


class FailingGraph(StandInGraph):
    """A stand-in whose capture runs its function and then fails."""

    def capture(self, fn):
        super().capture(fn)
        raise RuntimeError("capture failed")


def take_graph_path(monkeypatch):
    """CPU tensors captured and replayed, with `StandInGraph`; returns
    `kernel`, counted from 0."""
    monkeypatch.setattr(graphs, "graphable", lambda x: True)
    monkeypatch.setattr(graphs, "CudaGraph", StandInGraph)
    StandInGraph.made.clear()
    mod = types.ModuleType("mspl_tpu_torch.ops._stand_in")
    mod.kernel = kernel
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    kernel.launches = 0
    return kernel
