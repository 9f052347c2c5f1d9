"""Ensemble weight stacking (port of mspl_tpu/layers/stacking.py): run N
same-architecture models as one forward.

The pseudo-label loop runs `for m in models: logits_m = m(img)`: N
ESPNetv2 forwards that differ only in classifier width.  Stacked, the
ensemble is one network whose every channel dimension carries the N
models side by side, "m-major": the channels of every NCHW tensor run
[model0 | model1 | ...].

* a dense conv becomes a grouped conv with N groups (block-diagonal);
* a grouped conv of G groups becomes one of N*G groups: in m-major layout
  the stacked groups are the models' groups one after another, so the
  stacked weight is the models' weights concatenated along the output
  channels;
* depthwise convs, BatchNorm, PReLU, pools and resizes are per channel and
  stack by concatenating their parameters;
* the convs that read the raw image, which all models share (the encoder
  stem and the DownSampler reinforcement branches), stay dense with N
  times the outputs, and the input pyramid is pooled once for all models;
* a channel concat (the EESP branch merge, the DownSampler's pool ++
  EESP) interleaves per model to keep the layout m-major
  (`stacked_concat`), and the pyramid pool's channel shuffle runs per
  model.

Every extra product in the block-diagonal form is an exact zero, so the
stacked forward equals the per-model forwards up to the order of the
reductions (cuDNN picks its algorithms by shape, and 3x the channels is
another shape): tests/test_torch_stacking.py holds it at the reference's
tolerance (rtol 2e-3, atol 2e-4, argmax agreement above 0.999).

Heads of different widths (11 / 19 / 5 classes) stack by padding every
classifier to the widest head with zero weights and bias -1e4: the pad
classes get exactly 0 softmax mass, and zero rows of the label-space
tables (data/label_space.py) leave them out of the fusion.

`pad_variables_to_template` and `stack_variables` work on flax-layout
variable trees of numpy arrays (nested dicts, the form
`utils/flax_bridge.py::load_flax_variables` takes), so a stacked tree
loads into a model built with `stack=N`, and the JAX package's stacked
trees load unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def stacked_concat(tensors: Sequence[torch.Tensor], stack: int,
                   dim: int = 1) -> torch.Tensor:
    """Channel concat of NCHW tensors that keeps the m-major layout: each
    input's channels are [m0_c | m1_c | ...], and the output's model m
    block is [t0_m | t1_m | ...]."""
    if stack == 1:
        return torch.cat(list(tensors), dim=dim)
    if dim != 1:
        raise ValueError("the m-major concat is along channels (dim 1)")
    b, _, h, w = tensors[0].shape
    split = [t.reshape(b, stack, t.shape[1] // stack, h, w) for t in tensors]
    return torch.cat(split, dim=2).reshape(b, -1, h, w)


def stacked_shuffle(x: torch.Tensor, groups: int, stack: int) -> torch.Tensor:
    """The reference's channel `Shuffle` of each model's block of an m-major
    NCHW tensor: within a model, [groups, c] -> [c, groups]."""
    b, c, h, w = x.shape
    cm = c // stack
    x = x.reshape(b, stack, groups, cm // groups, h, w)
    return x.transpose(2, 3).reshape(b, c, h, w)


def block_diag_dense(weight: torch.Tensor, stack: int) -> torch.Tensor:
    """An m-major conv weight grouped by `stack`, OIHW [stack*cout_m,
    cin_m, kh, kw], as the dense block-diagonal weight [stack*cout_m,
    stack*cin_m, kh, kw] of the same conv."""
    cout, cin_m, kh, kw = weight.shape
    wg = weight.reshape(stack, cout // stack, cin_m, kh, kw)
    eye = torch.eye(stack, dtype=weight.dtype, device=weight.device)
    dense = torch.einsum("moihw,mM->moMihw", wg, eye)
    return dense.reshape(cout, stack * cin_m, kh, kw)


def flatten_tree(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    """{path tuple: leaf} of a tree of nested dicts (flax's
    `traverse_util.flatten_dict`)."""
    out: Dict[Path, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten_tree(flat: Mapping[Path, np.ndarray]) -> Dict:
    """The nested dicts of {path tuple: leaf} (flax's `unflatten_dict`)."""
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _concat_leaves(leaves: List[np.ndarray]) -> np.ndarray:
    a = np.asarray(leaves[0])
    if a.ndim == 0:
        return a
    return np.concatenate([np.asarray(x) for x in leaves], axis=-1)


def _interleave_leaves(leaves: List[np.ndarray], blocks: int) -> np.ndarray:
    """Per-channel parameters of a scale-major stacked tensor (the pyramid
    pool's `merge_br`: its branch stack concatenates per scale, so the
    stacked channels run [scale, model, p]): each model's [blocks*p] as
    [blocks, p], the models interleaved inside each block."""
    p = np.asarray(leaves[0]).shape[-1] // blocks
    split = [np.asarray(x).reshape(*np.shape(x)[:-1], blocks, 1, p)
             for x in leaves]
    out = np.concatenate(split, axis=-2)
    return out.reshape(*out.shape[:-3], blocks * len(leaves) * p)


def pad_variables_to_template(variables, template,
                              classify_path_tokens: Sequence[str] = (
                                  "bu_dec_l4", "classify"),
                              merge_br_blocks: int = 5):
    """Zero-pad a model's variable tree to a wider template's leaf shapes, so
    ensemble members with different classifier widths (and so different
    pyramid-pool proj widths) can stack.

    The padded channels are exact zeros everywhere: a conv weight pads with
    zero rows and columns, a BatchNorm with scale 0, bias 0, mean 0 and
    var 0 (any input to 0), PReLU(0) = 0; the final classifier's pad
    classes get bias -1e4 (exactly 0 softmax mass).  The true channels
    compute as in the unpadded model.  Only pads at the end of an axis are
    made; `merge_br`'s leaves lie on a scale-major tensor and pad per scale
    block."""
    fv, ft = flatten_tree(variables), flatten_tree(template)
    out = {}
    for k, leaf in fv.items():
        leaf = np.asarray(leaf)
        tgt = np.shape(ft[k])
        if leaf.shape == tgt:
            out[k] = leaf
            continue
        if not all(t >= s_ for t, s_ in zip(tgt, leaf.shape)):
            raise ValueError(f"{k}: template narrower than source, "
                             f"{leaf.shape} -> {tgt}")
        extra = tgt[-1] - leaf.shape[-1]
        if "merge_br" in k and extra:
            per = leaf.shape[-1] // merge_br_blocks
            blk = leaf.reshape(*leaf.shape[:-1], merge_br_blocks, per)
            blk = np.pad(blk, [(0, 0)] * (blk.ndim - 1)
                         + [(0, extra // merge_br_blocks)])
            out[k] = blk.reshape(*leaf.shape[:-1], tgt[-1])
        elif (all(tok in k for tok in classify_path_tokens)
              and k[-1] == "bias"):
            out[k] = np.concatenate(
                [leaf, np.full((extra,), -1e4, leaf.dtype)])
        else:
            # zero in-rows ignore the padded inputs, zero out-rows emit
            # exact-zero padded channels
            out[k] = np.pad(leaf, [(0, t - s_) for t, s_
                                   in zip(tgt, leaf.shape)])
    return unflatten_tree(out)


def stack_variables(variables_list, pad_classifier_to: int | None = None,
                    classify_path_tokens: Sequence[str] = ("bu_dec_l4",
                                                           "classify")):
    """Fold N per-model variable trees into one stacked model's tree.

    In m-major layout every leaf stacks by concatenation along its last
    axis (flax's conv kernels are HWIO and concatenate on O; BatchNorm's
    scale, bias, mean and var, PReLU's alpha and the biases on their only
    axis), except `merge_br`'s, which interleave per scale.

    `pad_classifier_to`: first pad each model's final classifier (the
    leaves whose path holds every one of `classify_path_tokens`) to this
    many classes: zero weights, bias -1e4."""
    def pad_tree(v):
        if pad_classifier_to is None:
            return v
        out = {}
        for k, leaf in flatten_tree(v).items():
            leaf = np.asarray(leaf)
            if all(tok in k for tok in classify_path_tokens):
                o = leaf.shape[-1]
                if k[-1] == "kernel" and o < pad_classifier_to:
                    leaf = np.pad(leaf, [(0, 0)] * (leaf.ndim - 1)
                                  + [(0, pad_classifier_to - o)])
                elif k[-1] == "bias" and o < pad_classifier_to:
                    leaf = np.concatenate(
                        [leaf, np.full((pad_classifier_to - o,), -1e4,
                                       leaf.dtype)])
            out[k] = leaf
        return unflatten_tree(out)

    flats = [flatten_tree(pad_tree(v)) for v in variables_list]
    out = {}
    for k in flats[0]:
        leaves = [f[k] for f in flats]
        if any(np.shape(x) != np.shape(leaves[0]) for x in leaves):
            raise ValueError(
                f"{k}: members disagree on shape "
                f"{[np.shape(x) for x in leaves]}; pad heterogeneous "
                "members with pad_variables_to_template first")
        if "merge_br" in k:
            out[k] = _interleave_leaves(leaves, blocks=5)
        else:
            out[k] = _concat_leaves(leaves)
    return unflatten_tree(out)
