#!/usr/bin/env python3
"""Run one cell of the benchmark of `mspl_tpu_torch` once, on this
machine's CUDA cards:

    python3 h100_bench/run.py --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

`BENCHMARK.json` at the checkout's root names the cell; its configuration,
traffic and limits are files of this folder, and the traffic's `driver`
(`drivers/<kind>.py`) runs it.  The last line of standard output is the
result as one JSON object (`--trace 0`: the end-to-end metrics; `--trace
1`: the per-layer metrics, the device's busy and window seconds, and the
breakdown); the last lines of standard error are each compared number
beside its limit.  Without enough CUDA cards, or with JAX or the JAX
package loaded, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# a later program that brings Triton or torch.compile caches its kernels
# here, inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(HERE / ".cache" / "inductor")
sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, cell=None) -> int:
    """Run the cell; `device` and `cell` are given only by the benchmark's
    own CPU tests, which skip the look for a card."""
    args = parse(argv)
    import torch

    from h100_bench import common, program

    if cell is None:
        cell = common.load_cell(args.workload)
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
                  f"torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = torch.device("cuda")
        tf32 = bool(cell.config.get("tf32", False))
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        program.build_libraries()
    driver = importlib.import_module(
        f"h100_bench.drivers.{cell.traffic['driver']}")
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     T_START)
    found = common.forbidden_loaded()
    if found:
        print(f"run.py: the process holds {found}; no result",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(common.checks_text(res.checks), file=sys.stderr, flush=True)
    print(common.result_line(res, device, cell.chips), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
