"""Ranks, the (model, data) mesh and its collectives (port of
mspl_tpu/parallel/mesh.py).

The JAX package drives every device from one process and lets XLA insert
the collectives.  The port runs one process (a rank) a card over
`torch.distributed`, as `torch.distributed.run` launches it, and inserts
them by hand.  What the JAX mesh promises holds here too:

* axis `data` shards each global batch into contiguous slices, one a data
  coordinate; train BatchNorm takes its statistics over the global batch
  (`layers/conv_blocks.py bn_sync`), the loss is a mean over the global
  batch's valid pixels (`engine/losses.py`), and the gradients are summed
  over the axis before the optimizer step;
* axis `model` places `sources[i::M]` on model slice i for pseudo-label
  generation, whose fusion sums are added over the axis
  (`pseudo/generate.py`);
* every rank of the job gets every result: generation's labels, the trained
  weights.  A mesh smaller than the job (`make_mesh_for_batch`) leaves its
  other ranks outside; they compute nothing and receive the results by
  broadcast from the mesh's first rank.  So every rank of the job calls an
  entry point with the same mesh, as every device runs the one JAX program.

Collectives on device tensors are `all_reduce` and `broadcast` only, the
two that both backends take on CUDA tensors (gloo serves no other there).
A gather is a zero-padded `all_reduce`: each rank writes its rows into a
buffer of zeros, and the sum holds every rank's rows.

The backend rule: `nccl` when every rank on a host has a card of its own,
`gloo` when ranks share a card or there is none (the CPU).  A rank's
device is `cuda:{local_rank % device_count}`.  JAX's `shard_map_compat`
has no counterpart: each rank runs its own shard's program already.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

AXES = ("model", "data")


def rank_device(local_rank: int) -> torch.device:
    """The card of the rank with this host-local index (the CPU without
    one)."""
    if torch.cuda.is_available():
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_distributed(rank: int, world_size: int, init_method: str,
                     local_rank: Optional[int] = None,
                     local_world_size: Optional[int] = None,
                     timeout_s: float = 1800.0) -> str:
    """Join a job of `world_size` ranks as `rank` through `init_method`
    (`env://`, `tcp://host:port`, `file://path`); `local_rank` and
    `local_world_size` (default `rank` and `world_size`: one host) place
    the rank on its host.  Picks the backend by the module's rule, makes
    the rank's card the current one, prints the choice on rank 0 and
    returns the backend's name."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world_size if local_world_size is None else local_world_size
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards and local_world <= cards:
        backend, why = "nccl", f"{local_world} ranks a host on {cards} cards"
    elif cards:
        backend, why = "gloo", (f"{local_world} ranks a host share "
                                f"{cards} card(s)")
    else:
        backend, why = "gloo", "no CUDA card"
    device = rank_device(local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"torch.distributed: {world_size} ranks, backend {backend} "
              f"({why}); rank 0 on {device}", flush=True)
    return backend


def maybe_init_distributed() -> bool:
    """Join a multi-process job when launch variables are present; returns
    True if this process is (now) one rank of such a job.

    Two launches are read: the JAX package's variables, MSPL_COORDINATOR
    (host:port of rank 0), MSPL_NUM_PROCESSES and MSPL_PROCESS_ID, and
    `torch.distributed.run`'s RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT.  Both take LOCAL_RANK and LOCAL_WORLD_SIZE where set
    (`torch.distributed.run` sets them; an MSPL_* launch of one host needs
    neither).  Without either launch nothing happens and False returns, so
    single-process runs (tests, the CLI) are untouched."""
    if dist.is_initialized():
        return True
    env = os.environ
    coord = env.get("MSPL_COORDINATOR")
    if coord:
        missing = [v for v in ("MSPL_NUM_PROCESSES", "MSPL_PROCESS_ID")
                   if v not in env]
        if missing:
            raise RuntimeError(
                "MSPL_COORDINATOR is set but required companion env var(s) "
                f"{', '.join(missing)} are missing; a multi-host launch must "
                "set all of MSPL_COORDINATOR, MSPL_NUM_PROCESSES, "
                "MSPL_PROCESS_ID")
        rank, world = int(env["MSPL_PROCESS_ID"]), int(env["MSPL_NUM_PROCESSES"])
        init_method = f"tcp://{coord}"
    elif "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init_method = "env://"
    else:
        return False
    local_world = env.get("LOCAL_WORLD_SIZE")
    init_distributed(rank, world, init_method,
                     local_rank=int(env.get("LOCAL_RANK", rank)),
                     local_world_size=(None if local_world is None
                                       else int(local_world)))
    return True


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """A (model, data) grid of ranks: `model` outer, `data` innermost, as
    the JAX package lays out its devices.

    `shape` {"model": M, "data": D}; `grid` int [M, D] of global ranks;
    `ranks` the grid's ranks in order; `coords` (m, d) of this process's
    rank, None outside the mesh; `first` the rank at (0, 0).  With
    `torch.distributed` initialized, the mesh holds a process group for
    each model slice's data axis and each data index's model axis, made by
    every rank of the job in the same order (a rank outside a group takes
    part in making it, or the job deadlocks).  Without it the mesh is the
    layout alone, which a single rank can use."""

    def __init__(self, grid: np.ndarray):
        self.grid = np.asarray(grid, np.int64)
        m, d = self.grid.shape
        self.shape: Dict[str, int] = {"model": int(m), "data": int(d)}
        self.ranks = tuple(int(r) for r in self.grid.reshape(-1))
        self.size = m * d
        self.first = self.ranks[0]
        self.rank = _rank()
        hit = np.argwhere(self.grid == self.rank)
        self.coords = (tuple(int(v) for v in hit[0]) if len(hit) else None)
        self._groups: Dict[str, object] = {}
        if dist.is_initialized():
            for i in range(m):
                g = dist.new_group(self.grid[i].tolist())
                if self.coords is not None and self.coords[0] == i:
                    self._groups["data"] = g
            for j in range(d):
                g = dist.new_group(self.grid[:, j].tolist())
                if self.coords is not None and self.coords[1] == j:
                    self._groups["model"] = g

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={list(self.ranks)})"

    @property
    def is_first(self) -> bool:
        return self.rank == self.first

    @property
    def has_outside(self) -> bool:
        """Whether the job has ranks outside this mesh."""
        return self.size < _world()

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is outside {self!r}")
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's slice along `axis` (None for a
        mesh of one rank without `torch.distributed`)."""
        self.index(axis)
        if not dist.is_initialized():
            if self.size > 1:
                raise RuntimeError(f"{self!r} needs torch.distributed; call "
                                   "maybe_init_distributed() first")
            return None
        return self._groups[axis]


def make_mesh(data: Optional[int] = None, model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A ('model', 'data') mesh over `ranks` (default every rank of the
    job): `model` source-model slices (1 = pure data parallelism), `data`
    inferred from the rank count when None."""
    pool = list(range(_world()) if ranks is None else ranks)
    n = len(pool)
    if data is None:
        if n % model:
            raise ValueError(f"rank count {n} not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {model}x{data} needs {model * data} ranks, "
                         f"have {n}")
    return Mesh(np.asarray(pool[: data * model]).reshape(model, data))


def make_mesh_for_batch(batch_size: int, model: int = 1,
                        ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh whose `data` axis is the largest that divides `batch_size`
    with `model` slices of `ranks` (default every rank of the job); the
    ranks it leaves out stay idle."""
    pool = list(range(_world()) if ranks is None else ranks)
    per_model = max(len(pool) // model, 1)
    data = math.gcd(batch_size, per_model)
    return make_mesh(data=data, model=model, ranks=pool[: data * model])


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's contiguous slice, along dim 0, of every array of a host
    global batch ("image", "label", "valid", "index", ...): rows
    [d * b, (d + 1) * b) of the data coordinate d, b = B / D."""
    d, n = mesh.index("data"), mesh.shape["data"]
    out = {}
    for k, v in batch.items():
        rows = len(v)
        if rows % n:
            raise ValueError(f"batch of {rows} does not split over a data "
                             f"axis of {n}")
        b = rows // n
        out[k] = v[d * b:(d + 1) * b]
    return out


def psum(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Sum `t` over this rank's slice of `axis`, in place; returns `t`."""
    group = mesh.group(axis)
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def gather_rows(t: torch.Tensor, mesh: Mesh,
                axis: str = "data") -> torch.Tensor:
    """The rows of every rank of this rank's slice of `axis`, in axis order:
    [b, ...] here -> [n * b, ...] on each of them, by a zero-padded
    `all_reduce`."""
    group = mesh.group(axis)
    if group is None:
        return t
    n, i, b = mesh.shape[axis], mesh.index(axis), t.shape[0]
    out = t.new_zeros((n * b, *t.shape[1:]))
    out[i * b:(i + 1) * b] = t
    dist.all_reduce(out, group=group)
    return out


def replicate(tree, mesh: Mesh):
    """Broadcast a module's parameters and buffers (or a dict of tensors)
    from the mesh's first rank to every rank of the job, in place; returns
    `tree`."""
    if not dist.is_initialized():
        return tree
    tensors = (list(tree.state_dict().values())
               if isinstance(tree, nn.Module) else list(tree.values()))
    for t in tensors:
        dist.broadcast(t.data, src=mesh.first)
    return tree


def broadcast_object(obj, mesh: Mesh):
    """A picklable host object as the mesh's first rank holds it, on every
    rank of the job."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.first)
    return box[0]


def share_with_outside(model: nn.Module, mesh: Optional[Mesh], obj):
    """Where the job has ranks outside `mesh`: the model's weights and
    `obj` from the mesh's first rank to every rank.  Returns `obj` as that
    rank holds it."""
    if mesh is None or not mesh.has_outside:
        return obj
    replicate(model, mesh)
    return broadcast_object(obj, mesh)


def barrier() -> None:
    """Wait for every rank of the job (nothing without one)."""
    if dist.is_initialized():
        dist.barrier()
