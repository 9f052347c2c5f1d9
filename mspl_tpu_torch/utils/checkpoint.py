"""Checkpoint save/load (port of mspl_tpu/utils/checkpoint.py), in the JAX
package's file format, so each package reads what the other writes.

A checkpoint is `<name>.msgpack`, flax's msgpack serialization of a tree
(`utils/_msgpack.py`: the model's `{"params", "batch_stats"}`, or a whole
train state with its optimizer buffers, in flax's layout), beside a JSON
sidecar `<name>.json` with the epoch, step and best metric.  Writes are
atomic (tmp + rename), so an interrupted run always leaves the last whole
checkpoint.  In the port the tree is nested dicts of numpy arrays (and
Python or numpy scalars): `load_checkpoint` returns one and the caller
restores it (`utils/flax_bridge.py` for a model, `engine/train.py
restore_train_state` for a train state).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

from mspl_tpu_torch.utils._msgpack import packb, unpackb

LAST_NAME = "checkpoint_last"
BEST_NAME = "checkpoint_best"


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_checkpoint(
    ckpt_dir: str,
    state: Any,
    meta: Optional[Dict] = None,
    is_best: bool = False,
    name: str = LAST_NAME,
) -> str:
    """Serialize `state` (a tree of dicts and arrays) + meta; copy both to
    the best checkpoint on a new best."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name + ".msgpack")
    _atomic_write(path, packb(state))
    meta_path = os.path.join(ckpt_dir, name + ".json")
    _atomic_write(meta_path, json.dumps(meta or {}).encode())
    if is_best:
        shutil.copyfile(path, os.path.join(ckpt_dir, BEST_NAME + ".msgpack"))
        shutil.copyfile(meta_path, os.path.join(ckpt_dir, BEST_NAME + ".json"))
    return path


def load_checkpoint(path_or_dir: str, best: bool = False
                    ) -> Tuple[Dict[str, Any], Dict]:
    """(tree, meta) of a checkpoint file, or of a directory's last (or
    best) checkpoint."""
    if os.path.isdir(path_or_dir):
        name = BEST_NAME if best else LAST_NAME
        path = os.path.join(path_or_dir, name + ".msgpack")
    else:
        path = path_or_dir
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    meta_path = os.path.splitext(path)[0] + ".json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return tree, meta


def has_checkpoint(ckpt_dir: str, best: bool = False) -> bool:
    name = BEST_NAME if best else LAST_NAME
    return os.path.exists(os.path.join(ckpt_dir, name + ".msgpack"))
