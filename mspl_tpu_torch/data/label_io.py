"""Label PNG IO and colorized visualization (port of
mspl_tpu/data/label_io.py).

Label maps are written as 8-bit grayscale PNGs through the native codec
(`native_io.encode_png`, PIL only where that fails, as in the reference):
the pseudo-label dumps of the `pseudo` command and of self-training rounds,
the `infer` command's predictions, and reference-format train lists beside
them.  `colorize_label` maps labels to RGB for inspection.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from mspl_tpu_torch.utils.registry import IGNORE_LABEL

# distinct colors for greenhouse classes: plant, artificial, ground (+ignore)
GREENHOUSE_PALETTE = np.asarray(
    [(0, 255, 0), (0, 0, 255), (255, 255, 0)], np.uint8
)


def save_label_png(label: np.ndarray, path: str) -> None:
    """Save an integer label map (255 = ignore) as an 8-bit grayscale
    PNG."""
    from mspl_tpu_torch.data.native_io import encode_png

    encode_png(path, np.asarray(label).astype(np.uint8))


def load_label_png(path: str) -> np.ndarray:
    """An 8-bit label PNG as uint8 [H, W], at its own size."""
    from mspl_tpu_torch.data import native_io

    if native_io.available():
        h, w = _png_size(path)
        return native_io.decode_png(path, (h, w), channels=1,
                                    bilinear=False)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im, np.uint8)


def _png_size(path: str) -> Tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    return (int.from_bytes(head[20:24], "big"),
            int.from_bytes(head[16:20], "big"))


def colorize_label(
    label: np.ndarray,
    palette: np.ndarray = GREENHOUSE_PALETTE,
    ignore_color: Tuple[int, int, int] = (0, 0, 0),
) -> np.ndarray:
    """Integer label map -> RGB viz (uint8 [H, W, 3])."""
    table = np.zeros((256, 3), np.uint8)
    table[: palette.shape[0]] = palette
    table[IGNORE_LABEL] = ignore_color
    return table[np.asarray(label).astype(np.int32)]


def save_colorized_png(label: np.ndarray, path: str,
                       palette: np.ndarray = GREENHOUSE_PALETTE) -> None:
    from mspl_tpu_torch.data.native_io import encode_png

    encode_png(path, colorize_label(label, palette))


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
