#!/usr/bin/env python3
"""Where the branch stack's time goes, shape by shape, on one CUDA card.

    python3 tools/torch_branch_breakdown.py [--profile]

Times `pyr_branches` (kernel ③) at the main path's nine calls of a batch
(batch 128, bf16; the decoder stages' planes 16x30, 32x60 and 64x120, the
three sources' P at each) shape by shape and all together, and the fused
pseudo-label pass (kernel ①) at its one call, the way `chip_smoke.py`
phase 3 times them: CUDA events over 5 repetitions after a warm-up, the
least of two runs.  Beside each plane's time it prints the host's time to
issue one call (host clock over 30 calls, no synchronization inside), which
bounds the plane's time when it is the larger.  With --profile, also each
kernel's device time a batch at each plane (torch.profiler over 5
repetitions): the down scales' pre-pass and the branch kernel apart.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from mspl_tpu_torch.data.label_space import label_conversion_matrix  # noqa
from mspl_tpu_torch.ops import _cuda, pseudo_cm, pyrpool  # noqa: E402


def device_ms(fn, reps: int = 5):
    """Device time a call of `fn` by kernel name (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0].split("<")[0].split()[-1]:
            e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also each kernel's device time by plane")
    args = ap.parse_args()
    smi = cs.phase_device()
    _cuda.build_all(("pyrpool", "pseudo_cm"))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    calls = cs.branch_calls(cs.BATCH, torch.bfloat16, gen)
    run = lambda: [pyrpool.pyr_branches(*a) for a in calls]  # noqa: E731
    total = min(cs.time_ms(run), cs.time_ms(run))
    shapes = cs.branch_by_shape(calls)
    host = {}
    for hw in cs.BRANCH_SHAPES:
        a = next(a for a in calls if tuple(a[0].shape[2:]) == hw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(30):
            pyrpool.pyr_branches(*a)
        host[hw] = (time.perf_counter() - t0) / 30 * 1e6
        torch.cuda.synchronize()
    print(f"branch breakdown on {smi}: 9 calls {total:.3f} ms a batch "
          f"(batch {cs.BATCH}, bf16) | " + ", ".join(
              f"{h}x{w} {ms:.3f} (host {host[(h, w)]:.0f} us a call)"
              for (h, w), ms in shapes.items()), flush=True)
    if args.profile:
        for hw in cs.BRANCH_SHAPES:
            sub = [a for a in calls if tuple(a[0].shape[2:]) == hw]
            dev = device_ms(lambda: [pyrpool.pyr_branches(*a) for a in sub])
            print(f"branch device time at {hw[0]}x{hw[1]} (ms a batch): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in dev.items()),
                  flush=True)
    del calls
    convs = [label_conversion_matrix(n) for n, _ in cs.SOURCES]
    kc = torch.full((3,), cs.KC, device="cuda")
    (logits,), = cs.pseudo_calls(cs.BATCH, torch.bfloat16, gen)
    run = lambda: pseudo_cm.fused_pseudo_cm(logits, convs, kc)  # noqa: E731
    ms = min(cs.time_ms(run), cs.time_ms(run))
    print(f"fused_pseudo_cm on {smi}: {ms:.3f} ms a batch (batch {cs.BATCH}, "
          f"bf16, {cs.HW[0]}x{cs.HW[1]}, C = "
          f"{', '.join(str(c) for _, c in cs.SOURCES)})", flush=True)


if __name__ == "__main__":
    main()
