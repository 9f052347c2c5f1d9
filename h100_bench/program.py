"""The benchmark's handles on the program under test, `mspl_tpu_torch`:
its models built from a configuration's `model` entry, its kernels'
launch counters and its library build."""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch


def build_libraries() -> None:
    """Compile every CUDA library of the port that is not yet built (one
    nvcc process a source, in parallel; cached in the checkout)."""
    from mspl_tpu_torch.ops import _cuda
    _cuda.build_all()


def model(spec: Dict, classes: int, dtype: torch.dtype, device,
          route: Optional[Dict] = None):
    """The port's segmentation model of `spec` (a configuration's `model`
    entry: the name and the constructor's keywords, every one passed on,
    so that a key the port does not take raises) on the configuration's
    `route` (keywords that choose the port's kernels, not its numbers),
    made on `device`."""
    from mspl_tpu_torch.models.factory import build_segmentation_model

    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in spec.items() if k != "name"}
    with torch.device(device):
        return build_segmentation_model(spec["name"], classes,
                                        compute_dtype=dtype, **kw,
                                        **(route or {}))


def launch_counters(names) -> Dict:
    """The kernel entries named `<module>.<function>` of the port's `ops`
    package (a cell's limits name them), whose `.launches` count their
    launches."""
    out = {}
    for name in names:
        mod, fn = name.rsplit(".", 1)
        out[name] = getattr(importlib.import_module(
            f"mspl_tpu_torch.ops.{mod}"), fn)
    return out

