"""Cells of the benchmark's shape at a size a CPU test holds: ESPNetv2 at
s = 0.5 and a one-block-a-stage DeepLab, 32x48 images, few of them.  They
carry the real cells' limits, so a test holds the tiny runs to the
yardstick the chip's runs are held to."""

from __future__ import annotations

import copy

import torch

from h100_bench import common

HW = [32, 48]
ESP = {"model": {"name": "espnetv2", "s": 0.5, "dec_base_planes": 16},
       "image_hw": HW,
       "sources": [
           {"name": "camvid", "dataset": "camvid", "classes": 11,
            "dtype": "bfloat16"},
           {"name": "cityscapes", "dataset": "cityscapes", "classes": 19,
            "dtype": "bfloat16"},
           {"name": "forest", "dataset": "forest", "classes": 5,
            "dtype": "bfloat16"}],
       "target": {"classes": 3, "dtype": "float32"}}
DEEPLAB = {"model": {"name": "deeplabv3", "stage_blocks": [1, 1, 1, 1],
                     "aspp_features": 16},
           "image_hw": HW, "target": {"classes": 3, "dtype": "float32"}}
CPU = torch.device("cpu")


def _limits(name: str):
    return common.load_json(common.HERE / "limits" / f"{name}.json")[
        "limits"]


def shrink_sweep(tr: dict) -> dict:
    """A sweep traffic at the tiny size."""
    tr = copy.deepcopy(tr)
    tr.update(batch=4, sweep_images=8, pool_images=8, loader_workers=1)
    return tr


def shrink_finetune(tr: dict) -> dict:
    """A fine-tune traffic at the tiny size."""
    tr = copy.deepcopy(tr)
    tr.update(batch=2, pool_images=8, crop_hw=HW, warm_steps=1,
              loader_workers=1, trace_skip=1, trace_steps=2)
    return tr


def sweep_cell(target: bool = False) -> common.Cell:
    real = "deeplabv3_r50.sweep_r1_b8" if target else \
        "espnetv2_s2.sweep_b128"
    tr = shrink_sweep(common.load_json(
        common.HERE / "traffic" / ("sweep_r1_b8.json" if target
                                   else "sweep_b128.json")))
    cfg = DEEPLAB if target else ESP
    return common.Cell(real, copy.deepcopy(cfg), tr,
                       configs={"espnetv2_s2": copy.deepcopy(ESP)},
                       limits=_limits(real))


def finetune_cell(model: str = "espnetv2") -> common.Cell:
    real = ("espnetv2_s2.finetune_b8" if model == "espnetv2"
            else "deeplabv3_r50.finetune_b8")
    tr = shrink_finetune(common.load_json(common.HERE / "traffic"
                                          / "finetune_b8.json"))
    cfg = ESP if model == "espnetv2" else DEEPLAB
    return common.Cell(real, copy.deepcopy(cfg), tr, limits=_limits(real))
