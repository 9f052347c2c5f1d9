#!/usr/bin/env python3
"""Where the fused pyramid-pool tail's time goes, scale by scale, on one
CUDA card.

    python3 tools/torch_tail_breakdown.py

Times `pyr_pool_fused_eval` (kernel ②) at the main path's three calls
(batch 128, bf16, 128x240, the classifier stage's P and O) with all five
scales, then with each scale left out and with each scale alone (the
depthwise taps, affines and merge weights sliced to the scales kept).  The
difference between the full tail and the tail without a scale is what that
scale costs; the tail with one scale alone shows the fixed part (staging,
merge, classifier).  CUDA events over 5 repetitions after a warm-up, the
least of two runs.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from mspl_tpu_torch.ops import _cuda, pyrpool  # noqa: E402


def keep_scales(args, keep):
    """The tail's arguments restricted to the scales at indices `keep`."""
    x, dw, aff1, mw, aff2, cls_w, cls_b, aff3, scales = args
    p = x.shape[1]
    cols = torch.tensor([si * p + c for si in keep for c in range(p)],
                        device=x.device)
    idx = torch.tensor(keep, device=x.device)
    return (x, dw[idx].contiguous(), aff1[:, cols].contiguous(),
            mw[:, :, idx].contiguous(), aff2, cls_w, cls_b, aff3,
            tuple(scales[i] for i in keep))


def main():
    smi = cs.phase_device()
    _cuda.build_all(("pyrpool",))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    calls = cs.tail_calls(cs.BATCH, torch.bfloat16, gen)
    n = len(cs.SCALES)

    def timed(keep):
        sub = [keep_scales(a, keep) for a in calls]
        run = lambda: [pyrpool.pyr_pool_fused_eval(*a) for a in sub]  # noqa
        return min(cs.time_ms(run), cs.time_ms(run))

    full = timed(list(range(n)))
    print(f"tail breakdown on {smi}: all {n} scales {full:.3f} ms a batch "
          f"({len(calls)} calls, batch {cs.BATCH}, bf16)", flush=True)
    for si, s in enumerate(cs.SCALES):
        without = timed([i for i in range(n) if i != si])
        alone = timed([si])
        print(f"  scale {s}: without it {without:.3f} ms (it costs "
              f"{full - without:.3f}), alone {alone:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
