"""What every driver shares: the cell as `BENCHMARK.json` and its files
describe it, the device's clock, seeded inputs, the comparison's numbers
and the result line."""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# module names that the process must not hold: JAX and the JAX package,
# compared by the whole top-level name (the port's name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mspl_tpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One `workloads` entry with its configuration and traffic files, and
    the metrics it reports."""
    name: str
    config: Dict
    traffic: Dict
    chips: int = 1
    end_to_end: List[str] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    configs: Dict[str, Dict] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)
    # each kernel's launches a batch or step, which the window must show
    launches: Dict[str, int] = field(default_factory=dict)

    def config_named(self, name: str) -> Dict:
        """Another configuration of the benchmark, by name (a sweep's
        source ensemble)."""
        return self.configs[name]


def metric_applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    """A metric with `workloads` belongs to those cells; a per-layer metric
    without it to every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_path)
    root = bench_path.parent
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload '{name}' in {bench_path}")
    configs = {c["name"]: load_json(root / c["file"])
               for c in bench["configs"]}
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    e2e = [m["name"] for m in bench["end_to_end"]
           if metric_applies(m, name, [])]
    layer = [m for m in bench["per_layer"] if metric_applies(m, name, e2e)]
    lim = load_json(HERE / "limits" / f"{name}.json")
    return Cell(name, configs[entry["config"]], traffic, entry["chips"],
                e2e, layer, configs, lim["limits"], lim["launches"])


class Clock:
    """Marks on the device's stream (CUDA events) or, on the CPU, the host
    clock; `ms(a, b)` after a synchronize."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def intervals_ms(clock: Clock, marks) -> List[float]:
    return [clock.ms(a, b) for a, b in zip(marks, marks[1:])]


def longest(values, n: int = 3):
    """The `n` longest intervals (ms) with their positions."""
    order = np.argsort(values)[::-1][:n]
    return [(int(i), round(float(values[i]), 1)) for i in order]


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def sub_seed(seed: int, *path: int) -> int:
    """A seed derived from the run's seed and a path of small integers."""
    s = np.random.SeedSequence([seed % 2 ** 63, *path])
    return int(s.generate_state(1, np.uint64)[0] % (2 ** 62))


def uint8_images(seed: int, n: int, hw, device) -> np.ndarray:
    """`n` distinct uint8 RGB images [n, H, W, 3], drawn on `device` in one
    call and brought to host memory (the loader serves them from there)."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.randint(0, 256, (n, *hw, 3), generator=g, device=device,
                      dtype=torch.uint8)
    return t.cpu().numpy()


@dataclass
class Check:
    """One compared number and its limit (`value <= limit` passes)."""
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Result:
    attempted: int
    metrics: Dict[str, Dict]
    checks: Dict[str, Check]
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict] = None

    @property
    def correct(self) -> bool:
        return all(c.ok for c in self.checks.values())

    @property
    def failed(self) -> int:
        """Every answer of the window is suspect when the comparison
        fails."""
        return 0 if self.correct else self.attempted


def checks_from(values: Dict[str, float],
                limits: Dict[str, float]) -> Dict[str, Check]:
    """The numbers that the cell's limits name (each must be there), each
    beside its limit."""
    return {k: Check(float(values[k]), float(lim))
            for k, lim in limits.items()}


def forbidden_in(names) -> List[str]:
    """The forbidden top-level names among module names `names`."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def forbidden_loaded() -> List[str]:
    return forbidden_in(list(sys.modules))


def device_info(device: torch.device, count: int, peak: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak)}


def result_line(res: Result, device: torch.device, count: int) -> str:
    dev = device_info(device, count, res.memory_peak_bytes)
    if res.busy_s is not None:
        dev["busy_s"], dev["window_s"] = res.busy_s, res.window_s
    line = {"correct": res.correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": res.metrics, "device": dev}
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = {k: {"value": c.value, "limit": c.limit}
                      for k, c in res.checks.items()}
    return json.dumps(line)


def checks_text(checks: Dict[str, Check]) -> str:
    return "\n".join(f"check {k}: {c.value!r} (limit {c.limit!r}) "
                     f"{'ok' if c.ok else 'FAILED'}"
                     for k, c in checks.items())


def sizes(n: int, block: int):
    """[start, stop) blocks of `block` over range(n)."""
    return [(i, min(i + block, n)) for i in range(0, n, block)]
