"""CUDA graphs of the port's forwards and backwards: what the two callers
that replay them share, each caller keeping its own policy (the
pseudo-label generator captures each source's eval forward,
`pseudo/generate.py`; the train step the model's train forward and
backward, `engine/train.py`).  A replay issues one launch where the host
issued hundreds.  `graphable` is the one switch: patched to say no, it
turns every graph off (`chip_smoke.py::plain_kernels`, the card tests'
eager twins); the CPU tests patch it to say yes and put a stand-in in
`CudaGraph`'s place (`tests/torch_graph_stand_in.py`)."""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Tuple

import torch
import torch.nn as nn

from mspl_tpu_torch.ops import pyrpool, resize_x2


def graphable(x: torch.Tensor) -> bool:
    """Whether work on `x` is captured into CUDA graphs and replayed."""
    return x.is_cuda


class CudaGraph:
    """One CUDA graph in a memory pool that several share."""

    new_pool = staticmethod(torch.cuda.graph_pool_handle)

    def __init__(self, pool):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool

    def capture(self, fn):
        """fn's output; its kernels are recorded on a side stream, not
        run."""
        with torch.cuda.graph(self.graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            return fn()

    def replay(self) -> None:
        """The recorded kernels, once, on the current stream."""
        self.graph.replay()


def launch_counters() -> list:
    """The port's kernel wrappers that count their launches: each entry of
    a loaded `mspl_tpu_torch.ops` module with an int `.launches`."""
    found = {}
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("mspl_tpu_torch.ops."):
            continue
        for fn in vars(mod).values():
            if callable(fn) and type(getattr(fn, "launches", None)) is int:
                found[id(fn)] = fn
    return list(found.values())


def kept(model: nn.Module) -> tuple:
    """What a graph of `model`'s forward keeps alive: the model's weights
    and every cached plan of ③ and ④ (the few a forward looks up are
    among them, and a cache may drop them later)."""
    return (tuple(model.parameters()), tuple(model.buffers()),
            tuple(p for lru in pyrpool._plan_cache.values()
                  for p in lru.values()),
            tuple(resize_x2._taps_cache.values()))


@dataclasses.dataclass
class Captured:
    """A captured graph: the output each replay writes, the launches each
    replay adds to the kernel wrappers' counters, and the tensors it keeps
    alive."""

    graph: CudaGraph
    output: Any
    launches: Tuple[Tuple[Callable, int], ...]
    keep: tuple

    def replay(self):
        """The captured kernels, once; returns `output`."""
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n
        return self.output


class Pool:
    """Graphs that share one memory pool, made at the first capture.  A
    capture may take memory that a graph captured before it freed, so the
    graphs must replay in the order of their captures."""

    handle = None

    def capture(self, fn: Callable, keep: tuple = ()) -> Captured:
        """`fn` captured into a new graph of the pool.  A capture runs the
        kernel wrappers' Python but no kernel, so their `.launches` are put
        back after it, also when it fails, and each replay adds what it
        counted: the counters count kernel runs, eager or replayed."""
        if self.handle is None:
            self.handle = CudaGraph.new_pool()
        counters = launch_counters()
        before = [f.launches for f in counters]
        graph = CudaGraph(self.handle)
        try:
            out = graph.capture(fn)
            launches = tuple((f, f.launches - n)
                             for f, n in zip(counters, before)
                             if f.launches != n)
        finally:
            for f, n in zip(counters, before):
                f.launches = n
        return Captured(graph, out, launches, keep)
