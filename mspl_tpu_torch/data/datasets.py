"""Data sets (port of mspl_tpu/data/datasets.py).

File-list segmentation data sets: CamVid, Cityscapes, Freiburg Forest
(sources) and Greenhouse (target).  Each is driven by a plain text list file
with one `image_path<sep>label_path` pair per line (sep = whitespace or
comma; `#` starts a comment line), paths relative to `root` unless
absolute: the reference's list format, which the pseudo-label dumps write
too.

Files are decoded at the edge to uint8 at the data set's canonical size
(PNGs through the native codec, `data/native_io.py`, which decodes a batch
on C++ threads into one buffer; other formats through PIL); every other
transform runs on the device (`data/transforms.py`).  A bounded cache of
decoded samples serves a self-training round's repeated sweeps.

`GreenhouseRGBD` reads unlabeled target lists (labels come back all
ignore), pseudo-label lists, and with `use_depth=True` the RGB-D form
(`rgb depth [label]` lines, a 4-channel image).  `SyntheticSegmentation`
makes deterministic procedural scenes, so every stage runs with no data set
on disk.  `ClassificationListDataset` reads the `image_path class_id` lists
of encoder pretraining.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from mspl_tpu_torch.data.label_space import CITYSCAPES_ID_TO_TRAINID
from mspl_tpu_torch.utils.registry import (IGNORE_LABEL, DatasetInfo,
                                           dataset_info)


def _read_list_file(root: str, list_file: str) -> List[Tuple[str, Optional[str]]]:
    pairs: List[Tuple[str, Optional[str]]] = []
    with open(list_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            img = parts[0]
            lab = parts[1] if len(parts) > 1 else None
            if not os.path.isabs(img):
                img = os.path.join(root, img)
            if lab is not None and not os.path.isabs(lab):
                lab = os.path.join(root, lab)
            pairs.append((img, lab))
    return pairs


def _load_image(path: str, size_wh: Tuple[int, int]) -> np.ndarray:
    if path.lower().endswith(".png"):
        from mspl_tpu_torch.data import native_io

        if native_io.available():  # C++ decode straight into a uint8 buffer
            return native_io.decode_png(path, (size_wh[1], size_wh[0]),
                                        channels=3, bilinear=True)
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if im.size != size_wh:
            im = im.resize(size_wh, Image.BILINEAR)
        return np.asarray(im, np.uint8)


def _load_label(path: str, size_wh: Tuple[int, int]) -> np.ndarray:
    if path.lower().endswith(".png"):
        from mspl_tpu_torch.data import native_io

        if native_io.available():
            return native_io.decode_png(path, (size_wh[1], size_wh[0]),
                                        channels=1, bilinear=False)
    from PIL import Image

    with Image.open(path) as im:
        if im.mode not in ("L", "P", "I"):
            im = im.convert("L")
        if im.size != size_wh:
            im = im.resize(size_wh, Image.NEAREST)
        arr = np.asarray(im)
        return arr.astype(np.uint8) if arr.dtype != np.uint8 else arr


class SegmentationDataset:
    """Base file-list dataset: `load(i)` → (uint8 [H,W,3] image,
    uint8 [H,W] label with 255=ignore)."""

    def __init__(
        self,
        info: DatasetInfo,
        root: str,
        list_file: str,
        size_wh: Optional[Tuple[int, int]] = None,
    ):
        self.info = info
        self.root = root
        self.size_wh = tuple(size_wh or info.size_wh)
        self.pairs = _read_list_file(root, list_file)
        if not self.pairs:
            raise ValueError(f"empty list file: {list_file}")

    def __len__(self) -> int:
        return len(self.pairs)

    @property
    def shape_hw(self) -> Tuple[int, int]:
        return (self.size_wh[1], self.size_wh[0])

    @property
    def num_classes(self) -> int:
        return self.info.num_classes

    @property
    def channels(self) -> int:
        return 4 if getattr(self, "use_depth", False) else 3

    def _convert_raw_label(self, label: np.ndarray) -> np.ndarray:
        return label

    # -- bounded decoded-uint8 cache -------------------------------------
    # A self-training round decodes the target set once for generation and
    # once per fine-tune epoch (SURVEY.md §3.3); the reference re-reads
    # PNGs from disk every epoch.  With the cache enabled, each image is
    # decoded once and every later sweep (any epoch, any round — the
    # dataset object persists across rounds) is a dict lookup.  Bounded by
    # bytes; beyond the budget items are served uncached (no eviction
    # churn).  Returned arrays are shared — callers must not mutate them.

    def enable_cache(self, cache_bytes: Optional[int] = None) -> None:
        import threading

        if cache_bytes is None:
            cache_bytes = int(os.environ.get(
                "MSPL_DECODE_CACHE_MB", "1024")) << 20
        self._cache = {}
        self._cache_lock = threading.Lock()
        self._cache_limit = int(cache_bytes)
        self._cache_used = 0

    def _cache_get(self, i: int):
        c = getattr(self, "_cache", None)
        return None if c is None else c.get(int(i))

    def _cache_put(self, i: int, img: np.ndarray, lab: np.ndarray) -> None:
        c = getattr(self, "_cache", None)
        if c is None:
            return
        nb = img.nbytes + lab.nbytes
        with self._cache_lock:
            if int(i) not in c and self._cache_used + nb <= self._cache_limit:
                c[int(i)] = (img, lab)
                self._cache_used += nb

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        hit = self._cache_get(i)
        if hit is not None:
            return hit
        img, lab = self._load_impl(int(i))
        self._cache_put(i, img, lab)
        return img, lab

    def _load_impl(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        img_path, lab_path = self.pairs[i]
        img = _load_image(img_path, self.size_wh)
        if lab_path is None:
            lab = np.full(self.shape_hw, IGNORE_LABEL, np.uint8)
        else:
            lab = self._convert_raw_label(_load_label(lab_path, self.size_wh))
        return img, lab

    def load_batch(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        if getattr(self, "_cache", None) is None:
            return self._load_batch_impl(indices)
        idx = [int(i) for i in indices]
        miss = sorted({i for i in idx if self._cache_get(i) is None})
        got = {}
        if miss:
            mimgs, mlabs = self._load_batch_impl(np.asarray(miss))
            for j, i in enumerate(miss):
                self._cache_put(i, mimgs[j], mlabs[j])
                got[i] = (mimgs[j], mlabs[j])
        samples = [self._cache_get(i) or got[i] for i in idx]
        return (np.stack([s[0] for s in samples]),
                np.stack([s[1] for s in samples]))

    def _load_batch_impl(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        """Batch fast path: decode all PNGs of the batch in parallel with the
        native C++ runtime (one preallocated buffer, no per-item Python).
        Falls back to per-item `load` when unavailable or for non-PNG files."""
        from mspl_tpu_torch.data import native_io

        pairs = [self.pairs[int(i)] for i in indices]
        all_png = all(
            p[0].lower().endswith(".png")
            and (p[1] is None or p[1].lower().endswith(".png"))
            for p in pairs
        )
        if not native_io.available() or not all_png:
            samples = [self._load_impl(int(i)) for i in indices]
            return (np.stack([s[0] for s in samples]),
                    np.stack([s[1] for s in samples]))

        h, w = self.shape_hw
        imgs = native_io.decode_png_batch([p[0] for p in pairs], (h, w),
                                          channels=3, bilinear=True)
        lab_paths = [p[1] for p in pairs]
        labs = np.full((len(pairs), h, w), IGNORE_LABEL, np.uint8)
        present = [j for j, lp in enumerate(lab_paths) if lp is not None]
        if present:
            decoded = native_io.decode_png_batch(
                [lab_paths[j] for j in present], (h, w), channels=1,
                bilinear=False)
            if decoded.ndim == 4:
                decoded = decoded[..., 0]
            for j, d in zip(present, decoded):
                labs[j] = self._convert_raw_label(d)
        return imgs, labs


class CamVidSegmentation(SegmentationDataset):
    def __init__(self, root: str, list_file: str, size_wh=None):
        super().__init__(dataset_info("camvid"), root, list_file, size_wh)


class CityscapesSegmentation(SegmentationDataset):
    def __init__(self, root: str, list_file: str, size_wh=None, raw_ids: bool = False):
        super().__init__(dataset_info("cityscapes"), root, list_file, size_wh)
        self.raw_ids = raw_ids

    def _convert_raw_label(self, label: np.ndarray) -> np.ndarray:
        if self.raw_ids:  # stock labelIds PNGs → train ids
            return CITYSCAPES_ID_TO_TRAINID[label.astype(np.int32)].astype(np.uint8)
        return label


class FreiburgForestSegmentation(SegmentationDataset):
    def __init__(self, root: str, list_file: str, size_wh=None):
        super().__init__(dataset_info("forest"), root, list_file, size_wh)


class GreenhouseRGBD(SegmentationDataset):
    """Target-domain dataset; labels are optional (unlabeled target images)
    or pseudo-label PNGs produced by the pseudo-label engine.

    ``use_depth=True`` ingests the reference's RGB-D form (SURVEY.md §2
    "Greenhouse RGB(-D)"): list lines are ``rgb depth [label]`` and
    ``load`` returns a uint8 [H, W, 4] image whose 4th channel is the
    depth map (8-bit PNG, or the high byte of a 16-bit PNG via the
    decoders' uint8 conversion).  The model consumes it by initializing
    with ``channels=4`` (the stem conv and the RGB-reinforcement pyramid
    are channel-count agnostic)."""

    def __init__(self, root: str, list_file: str, size_wh=None,
                 use_depth: bool = False):
        super().__init__(dataset_info("greenhouse"), root, list_file, size_wh)
        self.use_depth = use_depth
        if use_depth:
            # re-parse: column 2 is the depth map, column 3 the label
            self.depth_paths = []
            fixed = []
            with open(list_file) as f:
                rows = [ln.split() for ln in f
                        if ln.strip() and not ln.startswith("#")]
            for parts in rows:
                if len(parts) < 2:
                    raise ValueError(
                        "use_depth=True needs 'rgb depth [label]' lines")
                img, dep = parts[0], parts[1]
                lab = parts[2] if len(parts) > 2 else None
                to_abs = lambda p: (p if os.path.isabs(p)
                                    else os.path.join(self.root, p))
                fixed.append((to_abs(img), to_abs(lab) if lab else None))
                self.depth_paths.append(to_abs(dep))
            self.pairs = fixed

    def _load_impl(self, i: int):
        img, lab = super()._load_impl(i)
        if not self.use_depth:
            return img, lab
        depth = _load_label(self.depth_paths[i], self.size_wh)
        return np.concatenate([img, depth[..., None]], axis=-1), lab

    def _load_batch_impl(self, indices):
        if not self.use_depth:
            return super()._load_batch_impl(indices)
        imgs, labs = super()._load_batch_impl(indices)
        from mspl_tpu_torch.data import native_io

        dpaths = [self.depth_paths[int(i)] for i in indices]
        h, w = self.shape_hw
        if native_io.available() and all(
                p.lower().endswith(".png") for p in dpaths):
            depth = native_io.decode_png_batch(dpaths, (h, w), channels=1,
                                               bilinear=True)
            if depth.ndim == 4:
                depth = depth[..., 0]
        else:
            depth = np.stack([_load_label(p, self.size_wh) for p in dpaths])
        return np.concatenate([imgs, depth[..., None]], axis=-1), labs


class ClassificationListDataset:
    """Image-classification data set from a list file of `image_path
    class_id` lines (paths relative to `root` unless absolute; the list
    itself too), the input of encoder pretraining.  `load(i)` gives the
    uint8 [H, W, 3] image at `size_wh` and its int32 class;
    `num_classes` is 1 + the largest class in the list."""

    def __init__(self, root: str, list_file: str,
                 size_wh: Tuple[int, int] = (224, 224)):
        self.root = root
        self.size_wh = size_wh
        self.pairs: List[Tuple[str, int]] = []
        path = list_file if os.path.isabs(list_file) else os.path.join(
            root, list_file)
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                img = parts[0]
                if not os.path.isabs(img):
                    img = os.path.join(root, img)
                self.pairs.append((img, int(parts[1])))
        self.num_classes = 1 + max(c for _, c in self.pairs)

    def __len__(self) -> int:
        return len(self.pairs)

    @property
    def shape_hw(self) -> Tuple[int, int]:
        return (self.size_wh[1], self.size_wh[0])

    def load(self, i: int) -> Tuple[np.ndarray, np.int32]:
        img_path, cls = self.pairs[i]
        return _load_image(img_path, self.size_wh), np.int32(cls)


class SyntheticSegmentation:
    """Deterministic procedural scenes for tests/benchmarks: colored
    rectangles + background; labels follow the rectangle layout exactly,
    so a reasonable model can fit them and mIoU can approach 1."""

    def __init__(
        self,
        num_classes: int = 4,
        size_wh: Tuple[int, int] = (64, 48),
        length: int = 32,
        seed: int = 0,
        unlabeled: bool = False,
    ):
        self.info = DatasetInfo(name="synthetic", num_classes=num_classes,
                                size_wh=size_wh)
        self.size_wh = size_wh
        self.length = length
        self.seed = seed
        self.unlabeled = unlabeled
        self.num_classes = num_classes
        # distinct mean color per class so the task is learnable
        rng = np.random.default_rng(12345)
        self.palette = rng.integers(40, 215, size=(num_classes, 3)).astype(
            np.uint8)

    def __len__(self) -> int:
        return self.length

    @property
    def shape_hw(self) -> Tuple[int, int]:
        return (self.size_wh[1], self.size_wh[0])

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        h, w = self.shape_hw
        rng = np.random.default_rng(self.seed * 100003 + i)
        label = np.zeros((h, w), np.uint8)
        img = np.zeros((h, w, 3), np.float32)
        img += self.palette[0]
        for _ in range(4):
            c = int(rng.integers(1, self.num_classes))
            y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
            y1 = int(rng.integers(y0 + h // 8, h))
            x1 = int(rng.integers(x0 + w // 8, w))
            label[y0:y1, x0:x1] = c
            img[y0:y1, x0:x1] = self.palette[c]
        img += rng.normal(0, 8, size=img.shape)
        img = np.clip(img, 0, 255).astype(np.uint8)
        if self.unlabeled:
            label = np.full((h, w), IGNORE_LABEL, np.uint8)
        return img, label


def build_dataset(name: str, root: str, list_file: str, size_wh=None,
                  use_depth: bool = False):
    ctor = {
        "camvid": CamVidSegmentation,
        "cityscapes": CityscapesSegmentation,
        "forest": FreiburgForestSegmentation,
        "greenhouse": GreenhouseRGBD,
    }
    if name not in ctor:
        raise ValueError(f"unknown dataset '{name}'; have {sorted(ctor)}")
    if use_depth:
        if name != "greenhouse":
            raise ValueError("use_depth is only supported for greenhouse")
        return GreenhouseRGBD(root, list_file, size_wh, use_depth=True)
    return ctor[name](root, list_file, size_wh)
