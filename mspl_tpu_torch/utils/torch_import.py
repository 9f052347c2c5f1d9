"""Torch .pth checkpoint import/export (port of
mspl_tpu/utils/torch_import.py).

The reference ships its trained weights as torch state dicts in the layout
of its own modules, which the JAX package's torch twins
(`mspl_tpu/oracle/`) reproduce.  `import-torch` turns such a state dict
into the flax variable tree a native checkpoint holds, and `export-torch`
writes the twin's state dict from one.

`torch_leaf_map` is {twin state-dict name -> flax path}, or "dead" for a
twin tensor that no forward uses (ignored), or None for one the reference
fills with zeros because flax has no such leaf (a nonzero incoming value
raises, since importing would drop it).  The JAX package derives the map
by probing the twin's transplant; this package writes it down from the
twins' naming rules, on top of the port's own walk of the flax tree
(`utils/flax_bridge.py flax_leaves`):

- DeepLab: the port's `DeepLabV3` has the twin's `state_dict()` keys, so
  the map is the walk itself.
- ESPNetv2: the twin's CB holds its conv directly (`...cb.conv.weight`,
  the port `...cb.conv.conv.weight`), its PReLU is `nn.PReLU`
  (`act.weight`, the port `act.alpha`), an EESP's depthwise branches are
  convs `branches.{i}` (the port's `dw.{i}`), and a pyramid pool's branch
  kernels are convs `dw.{i}` (the port stacks them into `dw_weights`).
  The twin's DownSampler EESP builds a `module_act` that its forward never
  uses: dead.
BatchNorm's `num_batches_tracked` counters have no flax counterpart and are
ignored.  Conv kernels are OIHW in the twin and HWIO in flax.

Accepted state-dict envelopes: a bare {name: tensor} dict, or one under a
'state_dict' / 'model_state' / 'model' / 'weights' key (torch.save
checkpoint conventions); DataParallel 'module.' prefixes are stripped.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from mspl_tpu_torch.models import build_segmentation_model
from mspl_tpu_torch.utils.flax_bridge import STACK, flax_leaves

# torch BN bookkeeping buffers with no flax equivalent
_IGNORED_SUFFIXES = ("num_batches_tracked",)

# architecture-shaping meta keys forwarded into the model's constructor
_ARCH_META_KEYS = {
    "espnetv2": ("dec_base_planes",),
    "deeplabv3": ("stage_blocks", "aspp_features"),
}

# the models with a torch twin to import from and export to
TWIN_MODELS = tuple(_ARCH_META_KEYS)

Target = Union[str, None, Tuple[str, ...]]


def _espnetv2_twin_name(key: str, index: Optional[int]) -> str:
    if index is not None:  # a pyramid pool's stacked branch kernels
        return key[: -len("dw_weights")] + f"dw.{index}.weight"
    parts = key.split(".")
    if parts[-1] == "alpha":
        parts[-1] = "weight"
    elif len(parts) >= 2 and parts[-2] == "dw":  # EESP depthwise branch
        parts[-2:] = ["branches", parts[-1], "weight"]
    # a CB's C wrapper holds the conv: the twin's CB holds it directly
    return ".".join(parts).replace(".conv.conv.", ".conv.")


def _twin_table(model_name: str, num_classes: int, s: float = 2.0,
                **arch_kw) -> Dict[str, Tuple[Target, tuple]]:
    """{twin state-dict name: (flax path or "dead" or None, the twin
    tensor's shape)} for every twin tensor but the ignored counters, in
    the port walk's order."""
    if model_name not in _ARCH_META_KEYS:
        raise ValueError(f"no torch twin for model '{model_name}'")
    model = build_segmentation_model(model_name, num_classes, s=s, **arch_kw)
    sd = model.state_dict()
    table: Dict[str, Tuple[Target, tuple]] = {}
    for leaf in flax_leaves(model):
        shape = tuple(sd[leaf.key].shape)
        if leaf.layout == STACK:  # [S, 3, 3, P] -> one (P, 1, 3, 3) conv
            shape = (shape[3], 1, shape[1], shape[2])
        name = (leaf.key if model_name == "deeplabv3"
                else _espnetv2_twin_name(leaf.key, leaf.index))
        table[name] = (leaf.path, shape)
    if model_name == "espnetv2":
        for name in ("level2_0", "level3_0", "level4_0"):
            act = getattr(model.base_net, name).eesp.br_after_cat.act
            table[f"base_net.{name}.eesp.module_act.weight"] = (
                "dead", tuple(act.alpha.shape))
    return table


def torch_leaf_map(model_name: str, num_classes: int, s: float = 2.0,
                   **arch_kw) -> Dict[str, Target]:
    """{twin state-dict name -> flax path (a tuple of keys, collection
    first), "dead" or None}."""
    return {k: path for k, (path, _) in _twin_table(
        model_name, num_classes, s, **arch_kw).items()}


def unwrap_state_dict(obj) -> Dict[str, Any]:
    """Normalize a torch.load result: unwrap checkpoint envelopes, strip
    DataParallel 'module.' prefixes."""
    sd = obj
    if isinstance(sd, dict):
        for k in ("state_dict", "model_state", "model", "weights"):
            inner = sd.get(k)
            if isinstance(inner, dict) and inner and all(
                    hasattr(v, "shape") for v in inner.values()):
                sd = inner
                break
    if not isinstance(sd, dict):
        raise ValueError("not a state dict (or a recognized checkpoint "
                         f"envelope): {type(obj)}")
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _to_flax_layout(t: np.ndarray) -> np.ndarray:
    """Twin layout -> flax: conv OIHW -> HWIO, everything else as is."""
    if t.ndim == 4:
        return np.ascontiguousarray(np.transpose(t, (2, 3, 1, 0)))
    return np.ascontiguousarray(t)


def variables_from_state_dict(model_name: str, state_dict,
                              num_classes: int, s: float = 2.0,
                              **arch_kw) -> Dict:
    """A torch state dict (any accepted envelope) in the twin's layout ->
    the flax `{"params", "batch_stats"}` tree of float32 numpy arrays.
    Missing or unexpected tensors and wrong shapes raise, and so does a
    nonzero tensor that flax has no place for."""
    sd = {k: v for k, v in unwrap_state_dict(state_dict).items()
          if not k.endswith(_IGNORED_SUFFIXES)}
    table = _twin_table(model_name, num_classes, s, **arch_kw)
    missing = [k for k in table if k not in sd]
    unexpected = [k for k in sd if k not in table]
    if missing or unexpected:
        raise ValueError(
            f"state dict does not match the {model_name} architecture: "
            f"missing={missing[:5]} unexpected={unexpected[:5]}")
    tree: Dict = {}
    for name, (path, shape) in table.items():
        if path == "dead":
            continue
        arr = np.asarray(torch.as_tensor(sd[name]).detach().cpu().to(
            torch.float32).numpy())
        if path is None:
            if np.any(arr != 0):
                raise ValueError(
                    f"torch tensor '{name}' has no flax equivalent and is "
                    "nonzero: importing would drop it (the flax "
                    f"{model_name} has no such parameter)")
            continue
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{shape} of the {model_name} twin")
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(_to_flax_layout(arr), np.float32)
    return tree


def export_torch_state_dict(model_name: str, variables, num_classes: int,
                            s: float = 2.0, **arch_kw
                            ) -> Dict[str, torch.Tensor]:
    """flax variables -> the twin's state dict (its keys, in the port
    walk's order), for users moving weights back to a torch stack: dead
    tensors at the twin's construction value (a PReLU's 0.25), BatchNorm
    counters at 0."""
    sd: Dict[str, torch.Tensor] = {}
    for name, (path, shape) in _twin_table(model_name, num_classes, s,
                                           **arch_kw).items():
        if path == "dead":
            sd[name] = torch.full(shape, 0.25)
            continue
        leaf = variables
        for k in path:
            leaf = leaf[k]
        a = np.asarray(leaf, np.float32)
        if a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))
        sd[name] = torch.from_numpy(np.ascontiguousarray(a))
        if name.endswith(".running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return sd


def import_torch_checkpoint(path: str, meta: Dict[str, Any]):
    """Load a .pth/.pt checkpoint per `meta` ({'model', 'num_classes',
    's', ...}: the JSON sidecar schema of native checkpoints, with the
    architecture keys of `_ARCH_META_KEYS` honored).  Returns (model,
    variables, n_torch_tensors): the port's CPU model with the weights
    loaded, and the flax tree."""
    from mspl_tpu_torch.utils.flax_bridge import load_flax_variables

    if int(meta.get("in_channels", 3)) != 3:
        raise ValueError("torch import supports RGB (3-channel) weights "
                         "only: the reference's source models are RGB")
    arch_kw = arch_meta_kw(meta)
    nc, s = int(meta["num_classes"]), float(meta.get("s", 2.0))
    model = build_segmentation_model(
        meta["model"], nc, s=s,
        compute_dtype=torch.bfloat16 if meta.get("bf16") else torch.float32,
        **arch_kw)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    variables = variables_from_state_dict(meta["model"], obj, nc, s,
                                          **arch_kw)
    load_flax_variables(model, variables)
    return model, variables, len(unwrap_state_dict(obj))


def arch_meta_kw(meta) -> Dict:
    """The architecture-shaping kwargs a checkpoint's meta carries."""
    return {k: (tuple(meta[k]) if isinstance(meta[k], list) else meta[k])
            for k in _ARCH_META_KEYS.get(meta.get("model"), ())
            if k in meta}
