"""Pseudo-label PNG output (port of mspl_tpu/data/label_io.py:
`save_label_png`, `write_train_list`).

A self-training round with `out_dir` writes its thresholded labels as 8-bit
PNGs and a reference-format train list, for inspection and for the label
set on disk.  PIL is imported where a PNG is written, so the port needs it
only when labels are dumped.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def save_label_png(label: np.ndarray, path: str) -> None:
    """Save an integer label map (255 = ignore) as an 8-bit grayscale
    PNG."""
    from PIL import Image

    Image.fromarray(np.asarray(label).astype(np.uint8)).save(path)


def write_train_list(
    list_path: str,
    image_paths: Sequence[str],
    label_paths: Sequence[str],
) -> None:
    """Write a reference-format `image label` list file."""
    os.makedirs(os.path.dirname(list_path) or ".", exist_ok=True)
    with open(list_path, "w") as f:
        for img, lab in zip(image_paths, label_paths):
            f.write(f"{img} {lab}\n")
