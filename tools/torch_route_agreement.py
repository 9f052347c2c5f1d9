#!/usr/bin/env python3
"""Label agreement of the PyTorch port's kernel routes with its default
route, on the CPU (plain versions; no card needed).

    python tools/torch_route_agreement.py [--hw 256 480] [--batch 2]

Three ESPNetv2-s2.0 sources in bf16 with random weights from a seed (the
configuration `chip_smoke.py` drives), one batch of uint8 images from the
same seed, soft fusion, kc = 0.5.  The same weights go through the default
route, the models with `use_pallas=True` and with `fuse_stages=True`, and
NHWC sources with a `use_pallas=True` generator; the script prints each
route's share of labels equal to the default route's.  The encoder routes
round the EESP branch stack once in f32 where the default route rounds each
branch to bf16, so a few near-tied pixels flip; `chip_smoke.py` gates the
same agreement at 0.995 on the card.  A CPU run says nothing about time.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation, init_random
from mspl_tpu_torch.pseudo import generate

SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))
ROUTES = (("use_pallas", dict(use_pallas=True), True, False),
          ("fuse_stages", dict(fuse_stages=True), True, False),
          ("nhwc_use_pallas", {}, False, True))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", type=int, nargs=2, default=(256, 480))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    g = torch.Generator().manual_seed(args.seed)
    models = [init_random(ESPNetv2Segmentation(
        c, s=2.0, compute_dtype=torch.bfloat16), g).eval()
        for _, c in SOURCES]
    imgs = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, 256, (args.batch, *args.hw, 3), dtype=np.uint8))

    def labels(flags, channel_major, use_pallas):
        sources = []
        for (name, c), m in zip(SOURCES, models):
            routed = ESPNetv2Segmentation(c, s=2.0,
                                          compute_dtype=torch.bfloat16,
                                          **flags)
            routed.load_state_dict(m.state_dict())
            sources.append(generate.make_source(
                name, routed, None, name, channel_major=channel_major,
                device="cpu"))
        gen = generate.PseudoLabelGenerator(
            sources, kc=np.full(3, 0.5, np.float32), use_pallas=use_pallas,
            device="cpu")
        return gen.batch_pass(imgs)[0]

    default = labels({}, True, False)
    print(f"CPU, batch {args.batch} at {args.hw[0]}x{args.hw[1]}: kept "
          f"{(default != 255).float().mean().item():.5f} on the default "
          "route", flush=True)
    for name, flags, channel_major, use_pallas in ROUTES:
        agree = (labels(flags, channel_major, use_pallas) == default)
        print(f"{name}: label agreement with the default route "
              f"{agree.float().mean().item():.5f}", flush=True)


if __name__ == "__main__":
    main()
