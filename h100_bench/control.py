#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size:
the control (the plain reference in the program's place, computed in the
precision below the configuration's: fp8 under bf16, TF32 under f32) and,
for a fine-tune, the fault of half of each batch left out, each compared
with the plain reference by the cell's own numbers.

    python3 h100_bench/control.py --workload <name> --seeds 1 2 3

One JSON line a seed and reading.  The benchmark's runs never run this;
its sound runs' readings are the `checks` of their result lines.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100_bench import common  # noqa: E402
from h100_bench.drivers import finetune, sweep  # noqa: E402
from h100_bench.reference import layers as ref_layers  # noqa: E402
from h100_bench.reference import pipeline as ref  # noqa: E402


def sweep_readings(cell, seed, device):
    """The control's sweep against the reference's, by the cell's
    numbers."""
    tr = cell.traffic
    ms = sweep.members(cell)
    pool = common.uint8_images(common.sub_seed(seed, 2), tr["pool_images"],
                               tuple(cell.config["image_hw"]), device)
    states = sweep.member_states(ms, seed, pool, device)
    labels, confs = [], []

    def keep(lo, hi, label, conf):
        labels.append(label.to(torch.uint8))
        confs.append(conf)

    kc, hist = sweep.reference_sweep(ms, states, pool, tr, device,
                                     sweep.numerics(ms, control=True), keep)
    labels, confs = torch.cat(labels), torch.cat(confs)
    thr, cbsts = None, [(kc, hist)]
    if tr.get("apply_kc"):
        thr, cbsts = ref.apply_kc(labels.long(), confs, kc), [(kc, None)]
    values = sweep.compare(cell, ms, states, pool, labels, confs, thr, cbsts,
                           [], device)
    return {"control": values}


def order(n: int, seed: int) -> np.ndarray:
    """The shuffled order of epoch 0 (the loader's rule: seed + epoch)."""
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    return idx


def finetune_readings(cell, seed, device):
    tr = cell.traffic
    hw = tuple(cell.config["image_hw"])
    images, labels = finetune.make_pool(seed, tr, hw, device)
    loop_seed = common.sub_seed(seed, 5) % 2 ** 30
    idx = order(len(images), loop_seed)
    batches = [idx[i * tr["batch"]:(i + 1) * tr["batch"]]
               for i in range(tr["check_steps"])]

    def steps(**kw):
        return finetune.reference_steps(cell, seed, images, labels,
                                        batches, loop_seed, device, **kw)

    want = steps()
    out = {}
    for name, kw in (("control", {"num": ref_layers.TF32Numerics()}),
                     ("half_batch", {"half": True})):
        got = steps(**kw)
        out[name] = finetune.gaps(got, want)
    return out


def main(argv=None, device=None, cell=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if cell is None:
        cell = common.load_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("control.py: no CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    read = (sweep_readings if cell.traffic["driver"] == "sweep"
            else finetune_readings)
    for seed in args.seeds:
        for name, values in read(cell, seed, device).items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": name, "values": values}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
