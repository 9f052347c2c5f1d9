"""The port's models in the JAX package's flax variable layout, both ways.

`flax_leaves(model)` is the one walk between the two layouts: for every
leaf of the flax `{"params", "batch_stats"}` tree of
`mspl_tpu.models.ESPNetv2Segmentation`, `DeepLabV3` or the `EESPNet`
classifier (or of one EESP unit, as the kernel tests load units) it
yields the port's
state-dict key that holds it, the index into that tensor's first dimension
(or None), the flax path and the layout.  Everything else is built on it,
so loading, export and the optimizer's buffers (`engine/train.py`) cannot
drift apart:

- `load_flax_variables(model, variables)` copies a tree of nested dicts of
  numpy arrays (the caller converts JAX arrays with `np.asarray`; this
  package never imports JAX) into the model, in place;
- `flax_variables(model)` returns the tree flax would hold;
- `to_port` / `to_flax` convert between a tree and {state-dict key:
  tensor} for any collection, e.g. a momentum trace shaped like "params".
The round trip port -> flax -> port is bit-exact.

Layouts: `HWIO`, a conv kernel (grouped and depthwise ones included: flax
keeps (kh, kw, cin/groups, cout), torch (cout, cin/groups, kh, kw), so an
EESP depthwise kernel `dw_d{i}` is (3, 3, 1, n) against (n, 1, 3, 3) and
`merge_cbr`'s grouped merge after the channel shuffle (3, 3, S, P) against
(P, S, 3, 3)); `STACK`, one of the pyramid pool's branch kernels `dw_s{i}`
(3, 3, 1, P), indexed by the scales in descending order, which the port
stacks into one [S, 3, 3, P] tensor; `DENSE`, the classifier's flax
`Dense` kernel (in, out) against torch's `Linear` weight (out, in); `SAME`
for everything else.

The classifier's tree is its encoder's at the top level (`level1` ...
`level4_blocks_{i}`, as a segmentation model's `base_net` holds them),
then `level5_0` (a DownSampler without reinforcement), `level5_blocks_{i}`,
`level5_dw`, `level5_exp` and `classifier`.

A tree of an RGB-D model (a 4-channel stem) loads into a model built with
`in_channels=4`; a tree and a model of different channel counts raise on
the stem's shape.

DeepLab's leaves carry flax's auto-names in call order: a conv's kernel
sits under `_Conv_i/Conv_0` (explicit names for `stem`, `downsample`,
`project`, `low_proj`, `fuse`; the classifier is a bare `Conv` with a
bias), a BatchNorm's under `_BN_i/BatchNorm_0`.  So a bottleneck's
`downsample` BN is `_BN_3`; in the ASPP `_Conv_4`/`_BN_4` is the image
pool and `_BN_5` the projection's; at the top level `_BN_0` is
`low_proj`'s and `_BN_1` `fuse`'s.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mspl_tpu_torch.layers.eesp import EESP, DownSampler
from mspl_tpu_torch.layers.pyramid_pool import EfficientPWC, EfficientPyrPool
from mspl_tpu_torch.models.deeplab import DeepLabV3
from mspl_tpu_torch.models.espnetv2 import EESPNet

HWIO, STACK, DENSE, SAME = "hwio", "stack", "dense", "same"
Path = Tuple[str, ...]


class Leaf(NamedTuple):
    key: str              # the port's state-dict key
    index: Optional[int]  # into the key's first dim (STACK), else None
    path: Path            # flax path, collection first
    layout: str


def _k(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _conv(key: str, path: Path, bias: bool) -> Iterator[Leaf]:
    yield Leaf(_k(key, "weight"), None, ("params",) + path + ("kernel",),
               HWIO)
    if bias:
        yield Leaf(_k(key, "bias"), None, ("params",) + path + ("bias",),
                   SAME)


def _bn(key: str, path: Path) -> Iterator[Leaf]:
    for name, coll, leaf in (("weight", "params", "scale"),
                             ("bias", "params", "bias"),
                             ("running_mean", "batch_stats", "mean"),
                             ("running_var", "batch_stats", "var")):
        yield Leaf(_k(key, name), None, (coll,) + path + (leaf,), SAME)


def _prelu(key: str, path: Path) -> Iterator[Leaf]:
    yield Leaf(_k(key, "alpha"), None, ("params",) + path + ("alpha",),
               SAME)


def _c(mod, key: str, path: Path) -> Iterator[Leaf]:
    yield from _conv(_k(key, "conv"), path + ("Conv_0",),
                     mod.conv.bias is not None)


def _cb(mod, key: str, path: Path) -> Iterator[Leaf]:
    yield from _c(mod.conv, _k(key, "conv"), path + ("C_0",))
    yield from _bn(_k(key, "bn"), path + ("BatchNorm_0",))


def _cbr(mod, key: str, path: Path) -> Iterator[Leaf]:
    yield from _cb(mod.cb, _k(key, "cb"), path + ("CB_0",))
    yield from _prelu(_k(key, "act"), path + ("PReLU_0",))


def _br(key: str, path: Path) -> Iterator[Leaf]:
    yield from _bn(_k(key, "bn"), path + ("BatchNorm_0",))
    yield from _prelu(_k(key, "act"), path + ("PReLU_0",))


def _eesp(mod: EESP, key: str, path: Path) -> Iterator[Leaf]:
    yield from _cbr(mod.proj_1x1, _k(key, "proj_1x1"), path + ("proj_1x1",))
    for i in range(len(mod.dw)):
        yield Leaf(_k(key, f"dw.{i}"), None,
                   ("params",) + path + (f"dw_d{i}_kernel",), HWIO)
    yield from _br(_k(key, "br_after_cat"), path + ("br_after_cat",))
    yield from _cb(mod.conv_1x1_exp, _k(key, "conv_1x1_exp"),
                   path + ("conv_1x1_exp",))
    if not mod.avg:
        yield from _prelu(_k(key, "module_act"), path + ("module_act",))


def _down(mod: DownSampler, key: str, path: Path) -> Iterator[Leaf]:
    yield from _eesp(mod.eesp, _k(key, "eesp"), path + ("eesp",))
    if mod.reinf:
        yield from _cbr(mod.inp_reinf_cbr, _k(key, "inp_reinf_cbr"),
                        path + ("inp_reinf_cbr",))
        yield from _cb(mod.inp_reinf_cb, _k(key, "inp_reinf_cb"),
                       path + ("inp_reinf_cb",))
    yield from _prelu(_k(key, "act"), path + ("act",))


def _pyrpool(mod: EfficientPyrPool, key: str, path: Path) -> Iterator[Leaf]:
    yield from _cbr(mod.proj, _k(key, "proj"), path + ("proj",))
    for i in range(len(mod.scales)):
        yield Leaf(_k(key, "dw_weights"), i,
                   ("params",) + path + (f"dw_s{i}_kernel",), STACK)
    yield from _br(_k(key, "merge_br"), path + ("merge_br",))
    yield from _cbr(mod.merge_cbr, _k(key, "merge_cbr"),
                    path + ("merge_cbr",))
    yield from _c(mod.classify, _k(key, "classify"), path + ("classify",))
    if mod.last_br is not None:
        yield from _br(_k(key, "last_br"), path + ("last_br",))


def _pwc(mod: EfficientPWC, key: str, path: Path) -> Iterator[Leaf]:
    yield from _c(mod.wt_conv, _k(key, "wt_conv"), path + ("wt_conv",))
    yield from _cbr(mod.expand, _k(key, "expand"), path + ("expand",))


def _encoder(enc: EESPNet, key: str, path: Path) -> Iterator[Leaf]:
    yield from _cbr(enc.level1, _k(key, "level1"), path + ("level1",))
    for name in ("level2_0", "level3_0"):
        yield from _down(getattr(enc, name), _k(key, name), path + (name,))
    for i, blk in enumerate(enc.level3_blocks):
        yield from _eesp(blk, _k(key, f"level3_blocks.{i}"),
                         path + (f"level3_blocks_{i}",))
    yield from _down(enc.level4_0, _k(key, "level4_0"), path + ("level4_0",))
    for i, blk in enumerate(enc.level4_blocks):
        yield from _eesp(blk, _k(key, f"level4_blocks.{i}"),
                         path + (f"level4_blocks_{i}",))


def _classifier(model: EESPNet) -> Iterator[Leaf]:
    yield from _encoder(model, "", ())
    if model.num_classes is None:
        return
    yield from _down(model.level5_0, "level5_0", ("level5_0",))
    for i, blk in enumerate(model.level5_blocks):
        yield from _eesp(blk, f"level5_blocks.{i}", (f"level5_blocks_{i}",))
    for name in ("level5_dw", "level5_exp"):
        yield from _cbr(getattr(model, name), name, (name,))
    yield Leaf("classifier.weight", None, ("params", "classifier", "kernel"),
               DENSE)
    yield Leaf("classifier.bias", None, ("params", "classifier", "bias"),
               SAME)


def _espnetv2(model) -> Iterator[Leaf]:
    yield from _encoder(model.base_net, "base_net", ("base_net",))
    for name in ("bu_dec_l1", "merge_l2", "bu_dec_l2", "merge_l3",
                 "bu_dec_l3", "merge_l4", "bu_dec_l4"):
        mod = getattr(model, name)
        walk = _pyrpool if isinstance(mod, EfficientPyrPool) else _pwc
        yield from walk(mod, name, (name,))


def _dl_bn(key: str, path: Path, i: int) -> Iterator[Leaf]:
    yield from _bn(key, path + (f"_BN_{i}", "BatchNorm_0"))


def _deeplab(model: DeepLabV3) -> Iterator[Leaf]:
    yield from _conv("encoder.stem", ("encoder", "stem", "Conv_0"), False)
    yield from _dl_bn("encoder.stem_bn", ("encoder",), 0)
    for si, stage in enumerate(model.encoder.stages):
        for bi, blk in enumerate(stage):
            key, path = f"encoder.stages.{si}.{bi}", ("encoder",
                                                      f"stage{si}_{bi}")
            for i in range(3):
                yield from _conv(f"{key}.conv{i + 1}",
                                 path + (f"_Conv_{i}", "Conv_0"), False)
                yield from _dl_bn(f"{key}.bn{i + 1}", path, i)
            if blk.downsample is not None:
                yield from _conv(f"{key}.downsample.0",
                                 path + ("downsample", "Conv_0"), False)
                yield from _dl_bn(f"{key}.downsample.1", path, 3)
    aspp = model.aspp
    convs = ["aspp.b0"] + [f"aspp.bs.{i}" for i in range(len(aspp.bs))] + [
        "aspp.gp"]
    bns = ["aspp.bn0"] + [f"aspp.bns.{i}" for i in range(len(aspp.bns))] + [
        "aspp.gp_bn"]
    for i, (conv, bn) in enumerate(zip(convs, bns)):
        yield from _conv(conv, ("aspp", f"_Conv_{i}", "Conv_0"), False)
        yield from _dl_bn(bn, ("aspp",), i)
    yield from _conv("aspp.project", ("aspp", "project", "Conv_0"), False)
    yield from _dl_bn("aspp.project_bn", ("aspp",), len(bns))
    yield from _conv("low_proj", ("low_proj", "Conv_0"), False)
    yield from _dl_bn("low_bn", (), 0)
    yield from _conv("fuse", ("fuse", "Conv_0"), False)
    yield from _dl_bn("fuse_bn", (), 1)
    yield from _conv("classifier", ("classifier",), True)


def flax_leaves(model: torch.nn.Module) -> Iterator[Leaf]:
    """Every leaf of the model's flax tree, in the JAX model's call order:
    an ESPNetv2, DeepLab or EESPNet classifier model, or one EESP unit
    (its own tree)."""
    if isinstance(model, DeepLabV3):
        return _deeplab(model)
    if isinstance(model, EESP):
        return _eesp(model, "", ())
    if isinstance(model, EESPNet):
        return _classifier(model)
    return _espnetv2(model)


def from_flax(a, layout: str) -> torch.Tensor:
    """A flax leaf as the port holds it: float32, in a new CPU tensor of
    its own (never a view of the caller's array, which may be read-only,
    and which an optimizer buffer would otherwise write through)."""
    a = np.asarray(a, np.float32)
    if layout == HWIO:
        a = np.transpose(a, (3, 2, 0, 1))
    elif layout == STACK:
        a = a[:, :, 0, :]
    elif layout == DENSE:
        a = a.T
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def as_flax(t: torch.Tensor, layout: str) -> np.ndarray:
    """A port tensor (or one STACK slice of it) in flax's layout, as a new
    float32 numpy array."""
    a = t.detach().to("cpu", torch.float32).numpy()
    if layout == HWIO:
        a = np.transpose(a, (2, 3, 1, 0))
    elif layout == STACK:
        a = a[:, :, None, :]
    elif layout == DENSE:
        a = a.T
    return np.array(a, np.float32, order="C")


def get_path(tree: Mapping, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def to_port(model: torch.nn.Module, tree: Mapping,
            collections=("params", "batch_stats")) -> Dict[str, torch.Tensor]:
    """{state-dict key: float32 CPU tensor} of the leaves of `collections`
    in `tree`, at the port's shapes; raises on a missing leaf or a shape
    that differs from the model's."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for leaf in flax_leaves(model):
        if leaf.path[0] not in collections:
            continue
        try:
            t = from_flax(get_path(tree, leaf.path), leaf.layout)
        except KeyError as e:
            raise KeyError(f"flax tree has no leaf {'/'.join(leaf.path)}"
                           ) from e
        want = shapes[leaf.key]
        if leaf.index is not None:
            if leaf.key not in out:
                out[leaf.key] = torch.empty(want)
            dst, want = out[leaf.key][leaf.index], want[1:]
        if tuple(t.shape) != want:
            raise ValueError(f"{'/'.join(leaf.path)}: flax shape "
                             f"{tuple(t.shape)} != port shape {want} "
                             f"({leaf.key})")
        if leaf.index is None:
            out[leaf.key] = t
        else:
            dst.copy_(t)
    return out


def to_flax(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor],
            collections=("params", "batch_stats")) -> Dict:
    """The flax tree of `collections` (nested dicts of numpy arrays) from
    {state-dict key: tensor}; a key absent from `tensors` gives zeros."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    tree: Dict = {}
    for leaf in flax_leaves(model):
        if leaf.path[0] not in collections:
            continue
        t = tensors.get(leaf.key)
        if t is None:
            t = torch.zeros(shapes[leaf.key])
        if leaf.index is not None:
            t = t[leaf.index]
        node = tree
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = as_flax(t, leaf.layout)
    return tree


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Fill the port's `ESPNetv2Segmentation`, `DeepLabV3`, `EESPNet` or
    `EESP` unit from a flax variable tree of nested dicts of numpy arrays, in place;
    raises on any missing leaf or shape mismatch."""
    values = to_port(model, variables)
    sd = model.state_dict()
    with torch.no_grad():
        for k, t in values.items():
            sd[k].copy_(t)
    model.eval()


def flax_variables(model: torch.nn.Module) -> Dict:
    """The model's `{"params", "batch_stats"}` tree, as flax would hold it
    (nested dicts of float32 numpy arrays)."""
    return to_flax(model, model.state_dict())
