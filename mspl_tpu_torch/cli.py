"""Command line of the PyTorch port (port of mspl_tpu/cli.py), run as
`python -m mspl_tpu_torch.cli`.  The subcommands, their flag names and
their defaults are the JAX CLI's:

  train         source/target segmentation training
  pretrain      classification pretraining of the ESPNetv2 encoder
  eval          inference + per-class IoU table (`--save-viz` PNGs)
  infer         predict-only inference over an image list
  pseudo        single/multi-source pseudo-label generation
  selftrain     multi-round self-training
  import-torch  a reference-layout torch .pth -> a native checkpoint dir
  export-torch  a native checkpoint -> a torch .pth state dict

Checkpoints are the JAX package's files (`utils/checkpoint.py`): a model
checkpoint `model_best.msgpack` holds the flax `{"params",
"batch_stats"}` tree, its JSON meta ({dataset, model, s, num_classes,
bf16, input_hw, in_channels, ...}) rebuilds the network, and each package
reads what the other writes.

The command line runs on the CUDA card and fails without one; `main(argv,
device="cpu")` runs the same commands on the CPU (the tests do).  On the
card the pseudo-label sources are channel-major, so generation runs the
fused CUDA pass; on the CPU they are not, as in the JAX CLI.

`pretrain` writes an `eespnet_cls` checkpoint (meta `dataset:
classification`, `num_classes`, `input_hw`, `best_acc`) that `train
--pretrained-encoder` reads: the classifier's levels 1-4 initialize the
segmentation model's encoder.  `--remat` and `--bn-groups` reach `train`'s
train step; `selftrain` ignores them, as the JAX CLI's does.
`--cm-decoder` selects the JAX package's channel-major train decoder,
which that package holds identical to its NHWC one; the port's decoder is
channel-major already, so the flag changes nothing here but keeps the
reference's refusals (espnetv2 only, not with `--bn-groups` > 1).
`--model-parallel` > 1 (ROADMAP A.6) and `bench` (the port's benchmark,
the work of a benchmark change) exit with a message naming them.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mspl_tpu_torch.utils.print_utils import (print_info_message,
                                              print_warning_message)
from mspl_tpu_torch.utils.registry import (CONF_MODES, FUSION_MODES,
                                           MODEL_NAMES, SCHEDULER_NAMES,
                                           SEGMENTATION_DATASETS,
                                           dataset_info)
# the architecture-shaping kwargs a checkpoint meta carries (deeplabv3
# stage_blocks/aspp_features, espnetv2 dec_base_planes), honored on every
# rebuild from a meta
from mspl_tpu_torch.utils.torch_import import arch_meta_kw as _arch_meta_kw

MODEL_CKPT = "model_best"
_LATER = "belongs to a later slice of the PyTorch port (ROADMAP {})"


def _later(what: str, item: str) -> SystemExit:
    return SystemExit(f"{what} {_LATER.format(item)}")


def _save_model(ckpt_dir: str, variables: Dict, meta: Dict) -> None:
    from mspl_tpu_torch.utils.checkpoint import save_checkpoint

    save_checkpoint(ckpt_dir, variables, meta, name=MODEL_CKPT)


def _is_torch_ckpt(path: str) -> bool:
    return path.endswith((".pth", ".pt", ".pth.tar"))


def _meta_stem(path: str) -> str:
    for suf in (".pth.tar", ".pth", ".pt"):
        if path.endswith(suf):
            return path[: -len(suf)]
    return os.path.splitext(path)[0]


def load_model_checkpoint(path_or_dir: str) -> Tuple[Any, Dict, Dict]:
    """Load a model checkpoint saved by `train` (or by the JAX CLI), and
    rebuild the model from its meta.  Returns (model, variables, meta): the
    CPU model with the weights loaded, and the flax tree."""
    from mspl_tpu_torch.models import build_segmentation_model
    from mspl_tpu_torch.utils.checkpoint import load_checkpoint
    from mspl_tpu_torch.utils.flax_bridge import load_flax_variables

    if os.path.isdir(path_or_dir):
        path = os.path.join(path_or_dir, MODEL_CKPT + ".msgpack")
    else:
        path = path_or_dir
    if _is_torch_ckpt(path):
        # a torch .pth with the same-stem JSON meta sidecar
        from mspl_tpu_torch.utils.torch_import import import_torch_checkpoint

        with open(_meta_stem(path) + ".json") as f:
            meta = json.load(f)
        model, variables, _ = import_torch_checkpoint(path, meta)
        return model, variables, meta
    variables, meta = load_checkpoint(path)
    model = build_segmentation_model(
        meta["model"], num_classes=meta["num_classes"], s=meta.get("s", 2.0),
        compute_dtype=torch.bfloat16 if meta.get("bf16", False)
        else torch.float32,
        in_channels=int(meta.get("in_channels", 3)), **_arch_meta_kw(meta))
    load_flax_variables(model, variables)
    return model, variables, meta


def _print_model_card(model) -> None:
    """The parameter count at model build (the FLOPs wait for the port's
    profiling module, ROADMAP A.7)."""
    n_params = sum(p.numel() for p in model.parameters())
    print_info_message(f"model: {n_params / 1e6:.3f} M params")


def _check_cm_decoder(args) -> None:
    """--cm-decoder's refusals, as the JAX CLI's `_cm_decoder_kw`: the
    flag is espnetv2-only and takes no ghost-batch statistics."""
    if not getattr(args, "cm_decoder", False):
        return
    if args.model != "espnetv2":
        raise SystemExit("--cm-decoder is espnetv2-only")
    if getattr(args, "bn_groups", 1) > 1:
        raise SystemExit("--cm-decoder is incompatible with --bn-groups > 1")


def _check_model_parallel(args) -> None:
    if getattr(args, "model_parallel", 1) > 1:
        raise _later("--model-parallel > 1 (sources across devices)",
                     "A.6")


def _add_common_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="espnetv2", choices=MODEL_NAMES)
    p.add_argument("--s", type=float, default=2.0, help="ESPNetv2 width scaler")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--crop-size", type=int, nargs=2, default=None,
                   metavar=("W", "H"))
    p.add_argument("--size", type=int, nargs=2, default=None,
                   metavar=("W", "H"),
                   help="override the dataset's canonical image size")
    p.add_argument("--lr", type=float, default=0.009)
    p.add_argument("--scheduler", default="hybrid", choices=SCHEDULER_NAMES)
    p.add_argument("--optimizer", default="sgd", choices=("sgd", "adam"))
    p.add_argument("--weight-decay", type=float, default=4e-5)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--bf16", action="store_true",
                   help="run the conv stack in bfloat16")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward's activations in the "
                        "backward (activation checkpointing) to fit a "
                        "larger batch x crop in device memory")
    p.add_argument("--cm-decoder", action="store_true",
                   help="the JAX package's channel-major train decoder; "
                        "the port's decoder is channel-major already "
                        "(espnetv2 only)")
    p.add_argument("--bn-groups", type=int, default=1,
                   help="BatchNorm statistics scope: 1 = global batch "
                        "(default); N>1 = per contiguous batch group "
                        "(ghost-batch, per-replica BatchNorm)")
    p.add_argument("--rgbd", action="store_true",
                   help="greenhouse RGB-D: lists are 'rgb depth [label]', "
                        "the model stem takes 4 channels")
    p.add_argument("--ckpt-dir", default="./runs/ckpt")
    p.add_argument("--ckpt-every-steps", type=int, default=0,
                   help="also checkpoint every N optimizer steps mid-epoch "
                        "(--resume re-enters the epoch at the exact step)")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)


def _new_model(args, num_classes: int, in_ch: int):
    """A model of `args.model` at its initial weights (`init_model`,
    seed 0, as the JAX CLI's `init_model` takes PRNGKey(0))."""
    from mspl_tpu_torch.models import build_segmentation_model, init_model

    return init_model(build_segmentation_model(
        args.model, num_classes=num_classes, s=args.s,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        in_channels=in_ch), torch.Generator().manual_seed(0))


def cmd_train(args) -> Dict:
    from mspl_tpu_torch.data.datasets import build_dataset
    from mspl_tpu_torch.data.loader import DataLoader
    from mspl_tpu_torch.engine.losses import compute_class_weights
    from mspl_tpu_torch.engine.train import (TrainLoopConfig,
                                             train_segmentation)
    from mspl_tpu_torch.utils.flax_bridge import flax_variables

    _check_cm_decoder(args)
    if getattr(args, "pretrained_encoder", None) and args.model != "espnetv2":
        raise SystemExit("--pretrained-encoder initializes an espnetv2 "
                         "encoder")
    info = dataset_info(args.dataset)
    size_wh = tuple(args.size) if args.size else None
    use_depth = getattr(args, "rgbd", False)
    train_ds = build_dataset(args.dataset, args.data_root, args.train_list,
                             size_wh=size_wh, use_depth=use_depth)
    val_ds = (build_dataset(args.dataset, args.data_root, args.val_list,
                            size_wh=size_wh, use_depth=use_depth)
              if args.val_list else None)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              seed=args.seed)
    val_loader = DataLoader(val_ds, args.batch_size) if val_ds else None

    crop_wh = args.crop_size or size_wh or info.size_wh
    crop_hw = (crop_wh[1], crop_wh[0])
    in_ch = getattr(train_ds, "channels", 3)
    model = _new_model(args, info.num_classes, in_ch)
    _print_model_card(model)
    if getattr(args, "pretrained_encoder", None):
        _load_pretrained_encoder(model, args.pretrained_encoder)

    class_weights = None
    if args.class_weighting:
        hist = np.zeros(info.num_classes, np.int64)
        for i in range(min(len(train_ds), 200)):
            _, lab = train_ds.load(i)
            h, _ = np.histogram(lab[lab != 255], bins=info.num_classes,
                                range=(0, info.num_classes))
            hist += h
        class_weights = compute_class_weights(hist)

    cfg = TrainLoopConfig(
        epochs=args.epochs, crop_hw=crop_hw, lr=args.lr,
        scheduler=args.scheduler, optimizer=args.optimizer,
        weight_decay=args.weight_decay, seed=args.seed,
        ckpt_dir=args.ckpt_dir, log_dir=args.log_dir, resume=args.resume,
        remat=getattr(args, "remat", False),
        ckpt_every_steps=getattr(args, "ckpt_every_steps", 0),
        bn_groups=getattr(args, "bn_groups", 1),
    )
    res = train_segmentation(model, None, train_loader, val_loader,
                             info.num_classes, cfg,
                             class_weights=class_weights, device=args.device)
    _save_model(
        args.ckpt_dir, flax_variables(model),
        {"dataset": args.dataset, "model": args.model, "s": args.s,
         "num_classes": info.num_classes, "bf16": args.bf16,
         "input_hw": list(train_ds.shape_hw), "in_channels": in_ch,
         "best_miou": res["best_miou"]},
    )
    print_info_message(f"train done; best val mIoU {res['best_miou']:.4f}")
    return res


def _load_pretrained_encoder(model, pretrained: str) -> None:
    """Copy the encoder of the `pretrain` checkpoint `pretrained` (a dir or
    a .msgpack file, its meta beside it) into `model`'s `base_net`."""
    from mspl_tpu_torch.models import EESPNet
    from mspl_tpu_torch.models.espnetv2 import copy_encoder
    from mspl_tpu_torch.utils.checkpoint import load_checkpoint
    from mspl_tpu_torch.utils.flax_bridge import load_flax_variables

    path = (os.path.join(pretrained, MODEL_CKPT + ".msgpack")
            if os.path.isdir(pretrained) else pretrained)
    variables, pmeta = load_checkpoint(path)
    cls_model = EESPNet(s=pmeta.get("s", 2.0),
                        num_classes=pmeta["num_classes"])
    load_flax_variables(cls_model, variables)
    copy_encoder(model, cls_model)
    print_info_message(f"initialized encoder from {pretrained}")


def cmd_pretrain(args) -> Dict:
    """Classification pretraining of the ESPNetv2 encoder; the checkpoint
    feeds `train --pretrained-encoder`."""
    from mspl_tpu_torch.data.datasets import ClassificationListDataset
    from mspl_tpu_torch.data.loader import DataLoader
    from mspl_tpu_torch.engine.train_cls import (ClsTrainConfig,
                                                 train_classification)
    from mspl_tpu_torch.models import EESPNet, init_model
    from mspl_tpu_torch.utils.flax_bridge import flax_variables

    size_wh = tuple(args.size) if args.size else (224, 224)
    train_ds = ClassificationListDataset(args.data_root, args.train_list,
                                         size_wh=size_wh)
    val_ds = (ClassificationListDataset(args.data_root, args.val_list,
                                        size_wh=size_wh)
              if args.val_list else None)
    num_classes = max(train_ds.num_classes,
                      val_ds.num_classes if val_ds else 0)
    model = init_model(EESPNet(
        s=args.s, num_classes=num_classes,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32),
        torch.Generator().manual_seed(0))
    _print_model_card(model)
    cfg = ClsTrainConfig(epochs=args.epochs, lr=args.lr,
                         optimizer=args.optimizer, scheduler=args.scheduler,
                         weight_decay=args.weight_decay, seed=args.seed)
    res = train_classification(
        model, None,
        DataLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed),
        DataLoader(val_ds, args.batch_size) if val_ds else None, cfg,
        device=args.device)
    _save_model(
        args.ckpt_dir, flax_variables(model),
        {"dataset": "classification", "model": "eespnet_cls", "s": args.s,
         "num_classes": num_classes, "bf16": args.bf16,
         "input_hw": list(train_ds.shape_hw),
         "best_acc": res["best_acc"]},
    )
    print_info_message(f"pretrain done; best val acc {res['best_acc']:.4f}")
    return res


def _predict(model, imgs_u8, device, with_conf: bool = False):
    """Eval forward of a uint8 NHWC batch on `device`: the argmax map (and
    the max softmax probability) as tensors on `device`."""
    from mspl_tpu_torch.data.transforms import normalize

    model.eval()
    with torch.inference_mode():
        x = normalize(torch.as_tensor(imgs_u8).to(device))
        logits = model(x).float()
        if not with_conf:
            return logits.argmax(1), None
        p = torch.softmax(logits, dim=1)
        conf, pred = p.max(1)
        return pred, conf


def cmd_eval(args) -> Dict:
    from mspl_tpu_torch.data.datasets import build_dataset
    from mspl_tpu_torch.data.loader import DataLoader
    from mspl_tpu_torch.engine.train import evaluate, make_eval_step

    model, _, meta = load_model_checkpoint(args.checkpoint)
    ds = build_dataset(args.dataset or meta["dataset"], args.data_root,
                       args.val_list,
                       size_wh=tuple(args.size) if args.size else None)
    loader = DataLoader(ds, args.batch_size)
    nc = meta["num_classes"]
    eval_step = make_eval_step(model, nc, device=args.device)

    save_dir = getattr(args, "save_viz", None)
    if save_dir:
        # colorized prediction dumps in the same pass as the confusion
        # matrices: the set is traversed once
        from mspl_tpu_torch.data.label_io import save_colorized_png
        from mspl_tpu_torch.engine.metrics import MIOU, confusion_matrix

        os.makedirs(save_dir, exist_ok=True)
        palette = _viz_palette(nc, args.dataset or meta.get("dataset"))
        miou_acc = MIOU(nc)
        for batch in loader:
            pred, _ = _predict(model, batch["image"], args.device)
            lab = torch.as_tensor(batch["label"]).to(args.device)
            valid = torch.as_tensor(batch["valid"]).to(args.device)
            miou_acc.update(confusion_matrix(pred, lab, nc,
                                             batch_mask=valid))
            preds = pred.cpu().numpy()
            for j, idx in enumerate(np.asarray(batch["index"])):
                if not bool(batch["valid"][j]):
                    continue
                save_colorized_png(
                    preds[j],
                    os.path.join(save_dir, f"pred_{int(idx):06d}.png"),
                    palette)
        iou, miou = miou_acc.get_iou()
    else:
        iou, miou = evaluate(eval_step, loader, nc)
    info = dataset_info(args.dataset or meta["dataset"])
    names = info.class_names or [str(i) for i in range(nc)]
    for n, v in zip(names, iou):
        print(f"  {n:>16s}: IoU {v:.4f}")
    print_info_message(f"mIoU: {miou:.4f}")
    return {"iou": iou, "miou": miou}


def _viz_palette(num_classes: int, dataset: Optional[str]) -> np.ndarray:
    """Colorization palette: the canonical greenhouse colors, else a
    deterministic evenly-spaced HSV wheel sized to the label space."""
    import colorsys

    from mspl_tpu_torch.data.label_io import GREENHOUSE_PALETTE

    if dataset == "greenhouse" and num_classes <= GREENHOUSE_PALETTE.shape[0]:
        return GREENHOUSE_PALETTE
    cols = [colorsys.hsv_to_rgb(i / max(num_classes, 1), 0.75, 0.95)
            for i in range(num_classes)]
    return (np.asarray(cols) * 255).astype(np.uint8)


def cmd_infer(args) -> Dict:
    """Predict-only inference over an (optionally unlabeled) image list:
    raw prediction PNGs + colorized overlays (+ uint8 confidence maps)."""
    from mspl_tpu_torch.data.datasets import build_dataset
    from mspl_tpu_torch.data.label_io import (save_colorized_png,
                                              save_label_png)
    from mspl_tpu_torch.data.loader import DataLoader

    model, _, meta = load_model_checkpoint(args.checkpoint)
    model.to(args.device)
    use_depth = bool(getattr(args, "rgbd", False))
    ds = build_dataset(args.dataset or meta["dataset"], args.data_root,
                       args.list,
                       size_wh=tuple(args.size) if args.size else None,
                       use_depth=use_depth)
    ck_ch = int(meta.get("in_channels", 3))
    if ck_ch != ds.channels:
        raise SystemExit(
            f"checkpoint stem takes {ck_ch} channels but the image list "
            f"provides {ds.channels} (--rgbd mismatch)")
    loader = DataLoader(ds, args.batch_size)
    os.makedirs(args.out_dir, exist_ok=True)
    nc = int(meta["num_classes"])
    palette = _viz_palette(nc, args.dataset or meta.get("dataset"))

    n = 0
    for batch in loader:
        pred, conf = _predict(model, batch["image"], args.device,
                              with_conf=True)
        pred = pred.to(torch.uint8).cpu().numpy()
        conf = conf.cpu().numpy()
        for j, idx in enumerate(np.asarray(batch["index"])):
            if not bool(batch["valid"][j]):
                continue
            stem = f"{int(idx):06d}"
            save_label_png(pred[j],
                           os.path.join(args.out_dir, f"pred_{stem}.png"))
            save_colorized_png(pred[j],
                               os.path.join(args.out_dir, f"viz_{stem}.png"),
                               palette)
            if args.save_conf:
                save_label_png(
                    np.clip(conf[j] * 255.0, 0, 255).astype(np.uint8),
                    os.path.join(args.out_dir, f"conf_{stem}.png"))
            n += 1
    print_info_message(f"wrote {n} predictions -> {args.out_dir}")
    return {"n": n, "out_dir": args.out_dir}


def _load_sources(ckpts, num_target: int, device: torch.device):
    from mspl_tpu_torch.pseudo.generate import make_source

    # channel-major logits feed the fused CUDA pass on the card; the CPU
    # takes the JAX CLI's NHWC sources
    channel_major = device.type == "cuda"
    sources = []
    for c in ckpts:
        model, _, meta = load_model_checkpoint(c)
        sources.append(
            make_source(meta["dataset"], model, None, meta["dataset"],
                        num_target=num_target, channel_major=channel_major,
                        in_channels=int(meta.get("in_channels", 3)),
                        device=device))
    return sources


def _check_min_agree(min_agree, fusion: str, max_models: int) -> None:
    """Range-validate --min-agree: <= 0 would disable the agreement gate,
    > n_models would ignore every pixel, and the flag does nothing under
    soft fusion."""
    if min_agree is None:
        return
    if fusion != "hard":
        print_warning_message(
            f"--min-agree {min_agree} is ignored under --fusion {fusion}; "
            "it only affects hard fusion")
        return
    if not 1 <= min_agree <= max_models:
        raise SystemExit(
            f"--min-agree {min_agree} out of range: must be in "
            f"[1, {max_models}] (number of models voting)")


def cmd_pseudo(args) -> Dict:
    from mspl_tpu_torch.data.datasets import GreenhouseRGBD
    from mspl_tpu_torch.data.label_io import (save_colorized_png,
                                              save_label_png,
                                              write_train_list)
    from mspl_tpu_torch.data.loader import DataLoader
    from mspl_tpu_torch.pseudo.cbst import apply_kc_device, sweep_kc
    from mspl_tpu_torch.pseudo.generate import generate_pseudo_labels
    from mspl_tpu_torch.utils.registry import IGNORE_LABEL

    _check_model_parallel(args)
    info = dataset_info("greenhouse")
    t = info.num_classes
    _check_min_agree(args.min_agree, args.fusion, len(args.checkpoints))
    sources = _load_sources(args.checkpoints, t, args.device)
    ds = GreenhouseRGBD(args.data_root, args.target_list,
                        size_wh=tuple(args.size) if args.size else None,
                        use_depth=getattr(args, "rgbd", False))
    loader = DataLoader(ds, args.batch_size)
    conf_mode = args.conf_mode
    threshold = args.threshold
    if getattr(args, "entropy_threshold", None) is not None:
        # --entropy-threshold TAU drops pixels whose normalized entropy
        # H/ln(T+1) exceeds TAU, i.e. keeps conf = 1 - H/ln(T+1) >= 1 - TAU
        conf_mode = "entropy"
        threshold = 1.0 - args.entropy_threshold
    # labels and confidences stay on the device unless the confidences
    # must be dumped (--save-conf): the kc sweep and re-threshold run there
    # and only the final uint8 labels are fetched
    on_device = not args.save_conf
    labels, confs, indices = generate_pseudo_labels(
        sources, loader, mode=args.fusion, use_pallas=args.pallas,
        conf_mode=conf_mode, min_agree=args.min_agree,
        return_device=on_device, device=args.device)

    if args.p is not None:  # class-balanced thresholds
        kc = sweep_kc(labels, confs, t, args.p)
    else:
        kc = np.full(t, threshold, np.float32)
    if on_device:
        labels = apply_kc_device(labels, confs, kc).cpu().numpy().astype(
            np.int32)
    else:
        safe = np.where(labels == IGNORE_LABEL, 0, labels)
        labels = np.where(confs >= kc[safe], labels,
                          IGNORE_LABEL).astype(np.int32)

    os.makedirs(args.out_dir, exist_ok=True)
    img_paths, lab_paths = [], []
    for j, idx in enumerate(indices):
        lp = os.path.join(args.out_dir, f"pseudo_{int(idx):06d}.png")
        save_label_png(labels[j], lp)
        if args.save_viz:
            save_colorized_png(
                labels[j], os.path.join(args.out_dir,
                                        f"viz_{int(idx):06d}.png"))
        if args.save_conf:
            np.save(os.path.join(args.out_dir, f"conf_{int(idx):06d}.npy"),
                    confs[j].astype(np.float16))
        img_paths.append(ds.pairs[int(idx)][0])
        lab_paths.append(lp)
    write_train_list(os.path.join(args.out_dir, "train_list.txt"),
                     img_paths, lab_paths)
    kept = float((labels != IGNORE_LABEL).mean())
    print_info_message(
        f"pseudo-labels for {len(indices)} images -> {args.out_dir} "
        f"(kept {kept:.2%}, kc={np.round(kc, 3).tolist()})")
    return {"kc": kc, "kept": kept, "n": len(indices)}


def cmd_selftrain(args) -> Dict:
    from mspl_tpu_torch.data.datasets import GreenhouseRGBD
    from mspl_tpu_torch.data.loader import DataLoader
    from mspl_tpu_torch.pseudo.self_training import (SelfTrainConfig,
                                                     self_training)
    from mspl_tpu_torch.utils.flax_bridge import flax_variables

    _check_model_parallel(args)
    if not args.init_checkpoint:
        _check_cm_decoder(args)
    info = dataset_info("greenhouse")
    t = info.num_classes
    sources = _load_sources(args.checkpoints, t, args.device)
    size_wh = tuple(args.size) if args.size else None
    use_depth = getattr(args, "rgbd", False)
    target_ds = GreenhouseRGBD(args.data_root, args.target_list,
                               size_wh=size_wh, use_depth=use_depth)
    val_loader = None
    if args.val_list:
        val_ds = GreenhouseRGBD(args.data_root, args.val_list,
                                size_wh=size_wh, use_depth=use_depth)
        val_loader = DataLoader(val_ds, args.batch_size)

    in_ch = target_ds.channels
    if args.init_checkpoint:
        model, _, imeta = load_model_checkpoint(args.init_checkpoint)
        ck_ch = int(imeta.get("in_channels", 3))
        if ck_ch != in_ch:
            raise SystemExit(
                f"--init-checkpoint stem takes {ck_ch} channels but the "
                f"target set provides {in_ch} (--rgbd mismatch)")
    else:
        model = _new_model(args, t, in_ch)

    # the ensemble grows by the fine-tuned target model after round 0
    _check_min_agree(args.min_agree, args.fusion, len(args.checkpoints) + 1)
    crop_wh = args.crop_size or size_wh or info.size_wh
    cfg = SelfTrainConfig(
        rounds=args.rounds, p_init=args.p_init, p_step=args.p_step,
        fusion=args.fusion, conf_mode=args.conf_mode,
        min_agree=args.min_agree,
        batch_size=args.batch_size,
        epochs_per_round=args.epochs, crop_hw=(crop_wh[1], crop_wh[0]),
        lr=args.lr, optimizer=args.optimizer, scheduler=args.scheduler,
        weight_decay=args.weight_decay, reg_mode=args.reg_mode,
        reg_weight=args.reg_weight, seed=args.seed, out_dir=args.out_dir,
        ckpt_dir=args.ckpt_dir, use_pallas=args.pallas,
    )
    res = self_training(model, None, sources, target_ds, val_loader, t, cfg,
                        device=args.device)
    _save_model(
        args.ckpt_dir or "./runs/selftrain", flax_variables(res["model"]),
        {"dataset": "greenhouse", "model": args.model, "s": args.s,
         "num_classes": t, "bf16": args.bf16,
         "input_hw": list(target_ds.shape_hw), "in_channels": in_ch,
         "best_miou": res["best_miou"]},
    )
    print_info_message(f"self-training done; best mIoU {res['best_miou']:.4f}")
    return res


def cmd_import_torch(args) -> Dict:
    """Convert a reference-layout torch .pth checkpoint into a native
    checkpoint dir."""
    from mspl_tpu_torch.utils.torch_import import import_torch_checkpoint

    meta = {
        "model": args.model,
        "num_classes": args.num_classes,
        "s": args.s,
        "dataset": args.dataset,
        "bf16": bool(args.bf16),
        "input_hw": [args.size[1], args.size[0]] if args.size else None,
        "in_channels": 3,
        "imported_from": os.path.abspath(args.pth),
    }
    _, variables, n_keys = import_torch_checkpoint(args.pth, meta)
    _save_model(args.out_dir, variables, meta)
    print_info_message(
        f"imported {n_keys} torch tensors -> {args.out_dir} "
        f"({args.model}, {args.num_classes} classes, s={args.s})")
    return {"out_dir": args.out_dir, "n_torch_tensors": n_keys}


def cmd_export_torch(args) -> Dict:
    """Export a native checkpoint as a torch state dict (.pth) in the
    reference's (the torch twin's) layout."""
    from mspl_tpu_torch.utils.torch_import import export_torch_state_dict

    _, variables, meta = load_model_checkpoint(args.checkpoint)
    sd = export_torch_state_dict(
        meta["model"], variables, num_classes=int(meta["num_classes"]),
        s=float(meta.get("s", 2.0)), **_arch_meta_kw(meta))
    torch.save(sd, args.out)
    print_info_message(f"exported {len(sd)} tensors -> {args.out}")
    return {"out": args.out, "n_tensors": len(sd)}


def cmd_bench(args) -> Dict:
    raise SystemExit("bench: the port has no benchmark yet; defining what "
                     "it measures is the work of a benchmark change "
                     "(ROADMAP A.5)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mspl_tpu_torch",
        description="multi-source pseudo-label segmentation (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train a segmentation model")
    t.add_argument("--dataset", required=True, choices=SEGMENTATION_DATASETS)
    t.add_argument("--data-root", required=True)
    t.add_argument("--train-list", required=True)
    t.add_argument("--val-list", default=None)
    t.add_argument("--class-weighting", action="store_true")
    t.add_argument("--pretrained-encoder", default=None,
                   help="classification checkpoint (from `pretrain`) whose "
                        "encoder initializes the segmentation backbone")
    _add_common_train_flags(t)

    pt = sub.add_parser(
        "pretrain", help="classification-pretrain the ESPNetv2 encoder")
    pt.add_argument("--data-root", required=True)
    pt.add_argument("--train-list", required=True,
                    help='list file: "image_path class_id" per line')
    pt.add_argument("--val-list", default=None)
    _add_common_train_flags(pt)
    t.set_defaults(fn=cmd_train)
    pt.set_defaults(fn=cmd_pretrain, epochs=90, lr=0.5, scheduler="hybrid")

    e = sub.add_parser("eval", help="evaluate a checkpoint (per-class IoU)")
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--dataset", default=None, choices=SEGMENTATION_DATASETS)
    e.add_argument("--data-root", required=True)
    e.add_argument("--val-list", required=True)
    e.add_argument("--batch-size", type=int, default=8)
    e.add_argument("--size", type=int, nargs=2, default=None,
                   metavar=("W", "H"))
    e.add_argument("--save-viz", default=None, metavar="DIR",
                   help="also write colorized prediction PNGs to DIR")
    e.set_defaults(fn=cmd_eval)

    i = sub.add_parser(
        "infer", help="predict-only inference (no ground truth needed)")
    i.add_argument("--checkpoint", required=True)
    i.add_argument("--dataset", default=None, choices=SEGMENTATION_DATASETS,
                   help="overrides the checkpoint meta (palette/classes)")
    i.add_argument("--data-root", required=True)
    i.add_argument("--list", required=True,
                   help="image list (labels optional, ignored)")
    i.add_argument("--out-dir", required=True)
    i.add_argument("--batch-size", type=int, default=8)
    i.add_argument("--size", type=int, nargs=2, default=None,
                   metavar=("W", "H"))
    i.add_argument("--save-conf", action="store_true",
                   help="also write uint8 max-softmax confidence maps")
    i.add_argument("--rgbd", action="store_true",
                   help="'rgb depth' list lines; 4-channel checkpoints")
    i.set_defaults(fn=cmd_infer)

    g = sub.add_parser("pseudo", help="generate pseudo-labels")
    g.add_argument("--checkpoints", nargs="+", required=True,
                   help="source model checkpoints (1=single-source)")
    g.add_argument("--data-root", required=True)
    g.add_argument("--target-list", required=True)
    g.add_argument("--out-dir", required=True)
    g.add_argument("--fusion", default="soft", choices=FUSION_MODES)
    g.add_argument("--min-agree", type=int, default=None,
                   help="hard fusion: minimum models that must agree on a "
                        "pixel (default strict majority)")
    g.add_argument("--model-parallel", type=int, default=1,
                   help="place sources across a 'model' mesh axis of this "
                        "size (ROADMAP A.6)")
    g.add_argument("--rgbd", action="store_true",
                   help="greenhouse RGB-D target list ('rgb depth' lines); "
                        "3-channel sources see the RGB slice")
    g.add_argument("--conf-mode", default="prob", choices=CONF_MODES,
                   help="confidence family for thresholding: max-probability "
                        "or normalized anti-entropy")
    g.add_argument("--entropy-threshold", type=float, default=None,
                   metavar="TAU",
                   help="drop pixels whose normalized fused entropy exceeds "
                        "TAU (implies --conf-mode entropy; overrides "
                        "--threshold)")
    g.add_argument("--threshold", type=float, default=0.5)
    g.add_argument("--p", type=float, default=None,
                   help="class-balanced portion (overrides --threshold)")
    g.add_argument("--batch-size", type=int, default=8)
    g.add_argument("--save-viz", action="store_true")
    g.add_argument("--save-conf", action="store_true",
                   help="also write per-image fused confidence maps (.npy)")
    g.add_argument("--size", type=int, nargs=2, default=None,
                   metavar=("W", "H"))
    g.add_argument("--pallas", action="store_true")
    g.set_defaults(fn=cmd_pseudo)

    s = sub.add_parser("selftrain", help="multi-round MSPL self-training")
    s.add_argument("--checkpoints", nargs="+", required=True)
    s.add_argument("--data-root", required=True)
    s.add_argument("--target-list", required=True)
    s.add_argument("--val-list", default=None)
    s.add_argument("--init-checkpoint", default=None)
    s.add_argument("--rounds", type=int, default=3)
    s.add_argument("--p-init", type=float, default=0.2)
    s.add_argument("--p-step", type=float, default=0.05)
    s.add_argument("--fusion", default="soft", choices=FUSION_MODES)
    s.add_argument("--conf-mode", default="prob", choices=CONF_MODES)
    s.add_argument("--min-agree", type=int, default=None,
                   help="hard fusion: minimum models that must agree on a "
                        "pixel (default strict majority)")
    s.add_argument("--model-parallel", type=int, default=1,
                   help="place ensemble members across a 'model' mesh axis "
                        "of this size during generation (ROADMAP A.6)")
    s.add_argument("--reg-mode", default="kld", choices=("none", "kld", "ent"))
    s.add_argument("--reg-weight", type=float, default=0.1)
    s.add_argument("--out-dir", default=None)
    s.add_argument("--pallas", action="store_true")
    _add_common_train_flags(s)
    s.set_defaults(fn=cmd_selftrain, epochs=5, lr=1e-3, scheduler="poly")

    b = sub.add_parser("bench", help="run the headline benchmark "
                                     "(ROADMAP A.5)")
    b.set_defaults(fn=cmd_bench)

    it = sub.add_parser(
        "import-torch",
        help="convert a torch .pth checkpoint to a native checkpoint dir")
    it.add_argument("--pth", required=True, help="torch state dict / "
                    "checkpoint file (.pth/.pt/.pth.tar; 'module.' "
                    "prefixes and checkpoint envelopes handled)")
    it.add_argument("--model", required=True, choices=MODEL_NAMES)
    it.add_argument("--num-classes", type=int, required=True)
    it.add_argument("--s", type=float, default=2.0)
    it.add_argument("--dataset", default=None,
                    choices=SEGMENTATION_DATASETS,
                    help="recorded in the meta (drives label-space "
                         "conversion when used as a pseudo source)")
    it.add_argument("--size", type=int, nargs=2, default=None,
                    metavar=("W", "H"))
    it.add_argument("--bf16", action="store_true",
                    help="mark the model for bf16 compute at load time")
    it.add_argument("--out-dir", required=True)
    it.set_defaults(fn=cmd_import_torch)

    et = sub.add_parser(
        "export-torch",
        help="export a native checkpoint as a torch .pth state dict")
    et.add_argument("--checkpoint", required=True,
                    help="native checkpoint dir or .msgpack file")
    et.add_argument("--out", required=True, help="output .pth path")
    et.set_defaults(fn=cmd_export_torch)
    return ap


def main(argv=None, device="cuda"):
    """Parse `argv` (default: the command line) and run the subcommand on
    `device`; a CUDA device that is not there is an error."""
    args = build_parser().parse_args(argv)
    args.device = torch.device(device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mspl_tpu_torch.cli runs on a CUDA device and "
                         "torch sees none")
    return args.fn(args)


if __name__ == "__main__":
    main()
