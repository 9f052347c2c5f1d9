"""What a per-layer metric's reader gets, and the readings several readers
share: a kernel's share of its roofline and the whole step's share of the
card's peak.  Each metric is a file `metrics/<name>.py` with
`read(r: Reading) -> float | None`; None leaves the metric out of the
line."""

from __future__ import annotations

import importlib
import importlib.util
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import torch

from h100_bench import common
from h100_bench.roofline import peaks
from h100_bench.roofline.shapes import Model, model_key
from h100_bench.trace import TraceView


@dataclass
class Reading:
    view: TraceView
    units: int               # batches (sweep) or steps (train) profiled
    cell: common.Cell
    peak_bytes: int
    members: List            # the models: sweep Members, or [the target]
    hw: Tuple[int, int]      # image (sweep) or crop (train) size
    batch: int
    train: bool

    @property
    def window_s(self) -> float:
        return self.view.window_us / 1e6

    def per_unit_ms(self, us: float) -> Optional[float]:
        return us / 1e3 / self.units if self.units else None

    def models(self) -> List[Model]:
        return [Model(m.classes, torch.tensor([], dtype=m.dtype)
                      .element_size(), model_key(m.model))
                for m in self.members]


def roofline_share(r: Reading, kernel: str) -> Optional[float]:
    """100 x the bound time of the profiled calls of `kernel` (a module of
    `roofline/`) over their device time; None where none ran."""
    mod = importlib.import_module(f"h100_bench.roofline.{kernel}")
    dev_us, count = r.view.kernel_us(mod.KERNELS)
    calls = mod.calls(r.models(), r.hw, r.batch, r.train)
    if not count or not calls:
        return None
    bound, _ = peaks.bound_ms(*mod.work(calls))
    return 100.0 * bound * r.units / (dev_us / 1e3)


@lru_cache(maxsize=None)
def _conv_flops(key, classes: int, dtype: str, batch: int,
                hw: Tuple[int, int], train: bool) -> float:
    """Dense FLOPs (2 a multiply-add) of the reference model at these
    shapes, counted on meta tensors: an eval forward, or a train forward
    and backward.  The FLOP counter's ops whose names hold one of the
    model file's `DENSE_OPS` count ("convolution": the convolutions and
    their backward; "mm": mm, addmm, bmm, baddbmm)."""
    from torch.utils.flop_counter import FlopCounterMode

    from h100_bench.reference.pipeline import build_model, model_module

    spec = dict(key)
    families = model_module(spec["name"]).DENSE_OPS
    with torch.device("meta"):
        model = build_model(spec, classes, common.DTYPES[dtype])
        model.train(train)
        x = torch.empty(batch, 3, *hw)
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            model(x).float().sum().backward()
        else:
            with torch.no_grad():
                model(x)
    counts = counter.get_flop_counts()["Global"]
    return float(sum(v for k, v in counts.items()
                     if any(f in str(k) for f in families)))


def least_seconds(r: Reading) -> float:
    """The least time at the card's dense peaks for the profiled units:
    each model's dense FLOPs over the peak of its dtype."""
    total = 0.0
    for m in r.members:
        dtype = str(m.dtype).split(".")[-1]
        flops = _conv_flops(model_key(m.model), m.classes, dtype, r.batch,
                            tuple(r.hw), r.train)
        total += flops * r.units / peaks.DENSE_PEAK[dtype]
    return total


def mfu(r: Reading) -> Optional[float]:
    if r.window_s <= 0:
        return None
    return 100.0 * least_seconds(r) / r.window_s


def _reader(name: str):
    path = common.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_all(r: Reading) -> Dict[str, Dict]:
    """Every per-layer metric of the cell that its reader finds."""
    out = {}
    for m in r.cell.per_layer:
        value = _reader(m["name"]).read(r)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
