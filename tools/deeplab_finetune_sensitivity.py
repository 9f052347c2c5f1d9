#!/usr/bin/env python3
"""How far a few changed labels move a fine-tune, by model.

    python tools/deeplab_finetune_sensitivity.py [--reference]

From one initialization (`init_model`, seed 0) each 3-class model takes 8
SGD steps on the CPU (poly lr 1e-3, the CRST kld regularizer at 0.1, batch
4, 64x96, no augmentation: a self-training round's fine-tune) on random
uint8 batches, twice: once on random labels and once with 10 of them set
to ignore.  It prints the gap between the two tuned models, |a - b| /
|a - start| over all parameters.  A self-training round whose generation
changes a few labels hands its fine-tune exactly this perturbation.
`--reference` runs the same through the JAX package's train step (its
own initialization; it imports JAX) beside the PyTorch port's.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MODELS = ("deeplabv3", "espnetv2")
STEPS, BATCH, CLASSES = 8, 4, 3
HW, FLIPS = (64, 96), 10


def _data():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (STEPS, BATCH, *HW, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, (STEPS, BATCH, *HW)).astype(np.int32)
    flipped = labels.copy()
    flat = flipped.reshape(-1)
    flat[rng.choice(flat.size, FLIPS, replace=False)] = 255
    return imgs, labels, flipped


def _gap(a, b, start) -> float:
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in a)
    den = sum(float(np.sum((a[k] - start[k]) ** 2)) for k in a)
    return (num / den) ** 0.5


def port_gap(name) -> float:
    import torch

    from mspl_tpu_torch.engine.schedules import build_schedule
    from mspl_tpu_torch.engine.train import (create_train_state,
                                             make_train_step)
    from mspl_tpu_torch.models import build_segmentation_model, init_model

    model0 = init_model(build_segmentation_model(name, CLASSES),
                        torch.Generator().manual_seed(0))
    imgs, labels, flipped = _data()

    def tuned(labs):
        model = copy.deepcopy(model0)
        state = create_train_state(model, "sgd",
                                   build_schedule("poly", 1e-3, STEPS),
                                   device="cpu")
        step = make_train_step(model, reg_mode="kld", reg_weight=0.1,
                               augment=False, device="cpu")
        for i in range(STEPS):
            state, _ = step(state, {"image": imgs[i], "label": labs[i]})
        return {k: v.detach().double().numpy()
                for k, v in model.named_parameters()}

    start = {k: v.detach().double().numpy()
             for k, v in model0.named_parameters()}
    return _gap(tuned(labels), tuned(flipped), start)


def reference_gap(name) -> float:
    import jax
    import jax.numpy as jnp

    from mspl_tpu.engine.schedules import build_schedule
    from mspl_tpu.engine.train import (build_optimizer, create_train_state,
                                       make_train_step)
    from mspl_tpu.models import build_segmentation_model, init_model

    kw = {} if name == "deeplabv3" else {"channel_major_logits": True}
    model = build_segmentation_model(name, CLASSES, **kw)
    variables = init_model(model, HW, jax.random.PRNGKey(0))
    imgs, labels, flipped = _data()
    step = make_train_step(model, reg_mode="kld", reg_weight=0.1,
                           augment=False, donate=False)

    def tuned(labs):
        state = create_train_state(model, variables, build_optimizer(
            "sgd", build_schedule("poly", 1e-3, STEPS)))
        for i in range(STEPS):
            state, _ = step(state, {"image": jnp.asarray(imgs[i]),
                                    "label": jnp.asarray(labs[i])},
                            jax.random.PRNGKey(i))
        return {"/".join(str(p) for p in path): np.asarray(v, np.float64)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    state.params)[0]}

    start = {"/".join(str(p) for p in path): np.asarray(v, np.float64)
             for path, v in jax.tree_util.tree_flatten_with_path(
                 variables["params"])[0]}
    return _gap(tuned(labels), tuned(flipped), start)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", action="store_true",
                    help="also run the JAX package's train step (imports "
                         "JAX)")
    args = ap.parse_args()
    n = STEPS * BATCH * HW[0] * HW[1]
    for name in MODELS:
        print(f"{name}: {FLIPS} of {n} labels ignored -> tuned parameters "
              f"{port_gap(name):.4g} apart (port, cpu)", flush=True)
        if args.reference:
            print(f"{name}: the same through the JAX package: "
                  f"{reference_gap(name):.4g} apart", flush=True)


if __name__ == "__main__":
    main()
