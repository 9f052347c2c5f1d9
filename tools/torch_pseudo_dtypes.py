#!/usr/bin/env python3
"""The fused pseudo-label pass (kernel ①) by the dtypes of its ensemble,
on one CUDA card.

    python3 tools/torch_pseudo_dtypes.py [--repeats N]

Times `fused_pseudo_cm` the way `chip_smoke.py` phase 3 times it (CUDA
events over 5 repetitions after a warm-up, the least of N runs) on: the
main path's call (three bf16 sources of 11/19/5 classes, batch 128,
256x480, soft fusion, prob confidence, kc 0.5), the same logits in f32,
a self-training round's mixed ensemble (the three bf16 sources and an f32
3-class model, batch 8) and its three bf16 sources alone.  Each case is
timed through the instance that the wrapper picks (all f32, all bf16 or
mixed) and through the mixed instance alone, which reads any mix: the
cost of serving every ensemble with one instance (their labels and
confidences must be identical, else it raises).  Builds only the fused
pass's sources.  Prints the card's name and power limit first, one line
a case with its bound (bytes), and last one JSON object of the times.
To compare two builds of the kernel, run it from both trees in one call,
in turns.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from mspl_tpu_torch.data.label_space import label_conversion_matrix  # noqa
from mspl_tpu_torch.ops import _cuda, pseudo_cm  # noqa: E402


def cases(gen):
    """(name, logits, tables) of each timed call."""
    convs = [label_conversion_matrix(n) for n, _ in cs.SOURCES]
    (bf16,), = cs.pseudo_calls(cs.BATCH, torch.bfloat16, gen)
    yield "bf16 batch 128", bf16, convs
    yield "f32 batch 128", [x.float() for x in bf16], convs
    del bf16
    mixed, mixed_convs = cs.mixed_calls(cs.ROUND_BATCH, gen)
    yield "mixed batch 8", mixed, mixed_convs
    yield "bf16 batch 8", mixed[:3], mixed_convs[:3]


@contextlib.contextmanager
def mixed_instance():
    """Every launch of `fused_pseudo_cm` through the mixed instance."""
    pick = pseudo_cm._lib
    pseudo_cm._lib = lambda mixed: pick(True)
    try:
        yield
    finally:
        pseudo_cm._lib = pick


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs a case, the least kept (default 3)")
    args = ap.parse_args()
    smi = cs.phase_device()
    secs = _cuda.build_all([s for s in _cuda.SOURCES
                            if s.startswith("pseudo_cm")])
    print(f"build {secs:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    kc = torch.full((3,), cs.KC, device="cuda")
    times = {}
    for name, logits, convs in cases(gen):
        def run():
            pseudo_cm.fused_pseudo_cm(logits, convs, kc)
        got, outs = {}, []
        for inst, ctx in (("picked", contextlib.nullcontext),
                          ("mixed instance", mixed_instance)):
            with ctx():
                outs.append(pseudo_cm.fused_pseudo_cm(logits, convs, kc))
                got[inst] = min(cs.time_ms(run) for _ in range(args.repeats))
            times[f"{name}, {inst}"] = got[inst]
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"{name}: the instances disagree")
        b_ms = cs.bound(*cs.pseudo_work([(logits,)]))[0]
        print(f"fused_pseudo_cm {name}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in got.items())
            + f", bound {b_ms:.4f} ms on {smi}", flush=True)
    print(json.dumps(times), flush=True)


if __name__ == "__main__":
    main()
