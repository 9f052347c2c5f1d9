"""Self-training round loop (port of mspl_tpu/pseudo/self_training.py).

    for round r: generate pseudo-labels for the whole target set with the
    current ensemble -> grow the class-balanced portion p -> fine-tune the
    target model on the pseudo-labeled set (CE ignoring 255 + the CRST
    confidence regularizer) -> evaluate val mIoU -> repeat, with the
    fine-tuned target model joining the ensemble from
    `include_target_from_round` on.

Generation keeps its labels and confidences on the device
(`on_device=True`): the CBST histograms, kc and the re-threshold run there,
and one uint8 fetch a round brings the thresholded labels to the host.  The
target model joins the ensemble in its own label space (an identity table
plus a zero ignore column) as a module of its own, a copy made at its
first round and refreshed with the trained weights every later round
(`PseudoLabelGenerator.set_variables`), so generation (eval mode) and the
fine-tune (train mode) never share a module.  Its `compute_dtype=None`
keeps it out of the ensemble's input-cast vote: with bf16 sources it takes
the bf16-cast batch and computes in its own f32, and the fused pass reads
its f32 logits beside the sources' bf16 ones.

With `ckpt_dir`, round r's fine-tune checkpoints its train state into
`<ckpt_dir>/round{r}` (`train_segmentation`'s files, in the JAX package's
format).  The device mesh (ROADMAP A.6) belongs to a later slice of the
port and raises.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.nn as nn

from mspl_tpu_torch.data.loader import DataLoader
from mspl_tpu_torch.engine.train import (TrainLoopConfig, evaluate,
                                         make_eval_step, train_segmentation)
from mspl_tpu_torch.pseudo.cbst import apply_kc_device, sweep_kc
from mspl_tpu_torch.pseudo.generate import (PseudoLabelGenerator, SourceModel,
                                            load_variables, make_source)
from mspl_tpu_torch.utils.registry import IGNORE_LABEL


class PseudoLabeledDataset:
    """In-memory dataset pairing base-dataset images with generated labels
    (keyed by original sample index)."""

    def __init__(self, base_ds, labels: np.ndarray, indices: np.ndarray):
        self.base_ds = base_ds
        order = np.argsort(indices)
        self.indices = indices[order]
        self.labels = labels[order]
        self.num_classes = getattr(base_ds, "num_classes", None)

    def __len__(self) -> int:
        return len(self.indices)

    @property
    def shape_hw(self):
        return self.base_ds.shape_hw

    def load(self, i: int):
        img, _ = self.base_ds.load(int(self.indices[i]))
        return img, self.labels[i].astype(np.uint8)


@dataclass
class SelfTrainConfig:
    rounds: int = 3
    p_init: float = 0.2
    p_step: float = 0.05
    fusion: str = "soft"
    conf_mode: str = "prob"  # 'prob' | 'entropy' confidence family
    min_agree: Optional[int] = None
    batch_size: int = 8
    epochs_per_round: int = 5
    crop_hw: Tuple[int, int] = (256, 480)
    scale_range: Tuple[float, float] = (0.7, 1.3)
    lr: float = 1e-3
    optimizer: str = "sgd"
    scheduler: str = "poly"
    weight_decay: float = 4e-5
    reg_mode: str = "kld"  # CRST confidence regularization on pseudo pixels
    reg_weight: float = 0.1
    include_target_from_round: int = 1  # ensemble the tuned model from here
    # keep the generated labels and confidences on the device: kc sweep and
    # re-threshold run there, one uint8 host fetch a round
    on_device: bool = True
    seed: int = 0
    out_dir: Optional[str] = None  # dump label PNGs + train list per round
    ckpt_dir: Optional[str] = None  # round r checkpoints into round{r}/
    use_pallas: bool = False
    verbose: bool = True


def self_training(
    model: nn.Module,
    variables,
    sources: Sequence[SourceModel],
    target_ds,
    val_loader,
    num_classes: int,
    cfg: SelfTrainConfig,
    mesh=None,
    device="cuda",
) -> Dict[str, Any]:
    """Run the multi-round curriculum on `device`.

    model/variables: the target model to adapt, fine-tuned in place
    (`variables`, a flax tree of numpy arrays or a state dict, are loaded
    first; None keeps its weights).  sources: trained source models
    (`make_source`).  target_ds: the unlabeled target dataset.  Returns
    {'model', 'variables' (its state dict), 'history', 'best_miou'}."""
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh belongs to a later slice of the PyTorch port "
            "(ROADMAP A.6)")
    if variables is not None:
        load_variables(model, variables)
    model.to(device)
    history: List[Dict] = []
    best_miou = -1.0
    if hasattr(target_ds, "enable_cache"):
        target_ds.enable_cache()

    gen_plain: Optional[PseudoLabelGenerator] = None  # sources only
    gen_tgt: Optional[PseudoLabelGenerator] = None    # sources + target

    def _make_target_source():
        identity = np.concatenate(
            [np.eye(num_classes, dtype=np.float32),
             np.zeros((num_classes, 1), np.float32)], axis=1)
        return make_source(
            "target", copy.deepcopy(model), None, "greenhouse",
            num_target=num_classes,
            channel_major=bool(sources) and sources[0].channel_major,
            in_channels=int(getattr(target_ds, "channels", 3)),
            conversion=identity, compute_dtype=None, device=device)

    def _make_generator(ensemble):
        return PseudoLabelGenerator(
            ensemble, mode=cfg.fusion, use_pallas=cfg.use_pallas,
            conf_mode=cfg.conf_mode, min_agree=cfg.min_agree, device=device)

    for r in range(cfg.rounds):
        p = min(cfg.p_init + r * cfg.p_step, 1.0)
        if r >= cfg.include_target_from_round and r > 0:
            if gen_tgt is None:
                gen_tgt = _make_generator(list(sources)
                                          + [_make_target_source()])
            else:
                gen_tgt.set_variables(len(sources), model.state_dict())
            gen = gen_tgt
        else:
            if gen_plain is None:
                gen_plain = _make_generator(list(sources))
            gen = gen_plain

        gen_loader = DataLoader(target_ds, batch_size=cfg.batch_size,
                                shuffle=False)
        labels, confs, indices = gen(gen_loader, return_device=cfg.on_device)
        kc = sweep_kc(labels, confs, num_classes, p)
        if cfg.on_device:
            # one uint8 host fetch of the thresholded labels a round
            labels_thr = apply_kc_device(labels, confs, kc).cpu().numpy(
                ).astype(np.int32)
        else:
            safe = np.where(labels == IGNORE_LABEL, 0, labels)
            keep = confs >= kc[safe]
            labels_thr = np.where(keep, labels, IGNORE_LABEL).astype(np.int32)
        frac_kept = float((labels_thr != IGNORE_LABEL).mean())

        if cfg.out_dir:
            _dump_round(cfg.out_dir, r, labels_thr, indices, target_ds)

        pseudo_ds = PseudoLabeledDataset(target_ds, labels_thr, indices)
        train_loader = DataLoader(pseudo_ds, batch_size=cfg.batch_size,
                                  shuffle=True, seed=cfg.seed + r)
        tcfg = TrainLoopConfig(
            epochs=cfg.epochs_per_round, crop_hw=cfg.crop_hw,
            scale_range=cfg.scale_range, lr=cfg.lr, scheduler=cfg.scheduler,
            optimizer=cfg.optimizer, weight_decay=cfg.weight_decay,
            reg_mode=cfg.reg_mode, reg_weight=cfg.reg_weight,
            seed=cfg.seed + r, verbose=False,
            ckpt_dir=(os.path.join(cfg.ckpt_dir, f"round{r}")
                      if cfg.ckpt_dir else None))
        res = train_segmentation(model, None, train_loader, val_loader,
                                 num_classes, tcfg, device=device)
        miou = res["best_miou"]
        if val_loader is not None and miou < 0:
            _, miou = evaluate(make_eval_step(model, num_classes,
                                              device=device),
                               val_loader, num_classes)
        best_miou = max(best_miou, miou)
        history.append({
            "round": r, "p": p, "kc": kc.tolist(),
            "frac_kept": frac_kept, "miou": miou,
            "n_sources": len(gen.sources),
        })
        if cfg.verbose:
            print(f"round {r}: p={p:.2f} kept={frac_kept:.2%} "
                  f"sources={len(gen.sources)} val mIoU={miou:.4f}",
                  flush=True)

    return {"model": model, "variables": model.state_dict(),
            "history": history, "best_miou": best_miou}


def _dump_round(out_dir: str, r: int, labels: np.ndarray,
                indices: np.ndarray, ds) -> None:
    from mspl_tpu_torch.data.label_io import save_label_png, write_train_list

    rd = os.path.join(out_dir, f"round{r}")
    os.makedirs(rd, exist_ok=True)
    img_paths, lab_paths = [], []
    for j, idx in enumerate(indices):
        lp = os.path.join(rd, f"pseudo_{int(idx):06d}.png")
        save_label_png(labels[j], lp)
        pair = getattr(ds, "pairs", None)
        img_paths.append(pair[int(idx)][0] if pair else f"index:{int(idx)}")
        lab_paths.append(lp)
    write_train_list(os.path.join(rd, "train_list.txt"), img_paths, lab_paths)
