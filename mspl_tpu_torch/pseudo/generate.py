"""Pseudo-label engine (port of mspl_tpu/pseudo/generate.py).

N source segmentation models run over a batch of unlabeled target images;
per pixel, each model's softmax is converted into the greenhouse label space
through its [C_src, T+1] pooling table, the converted maps are fused (soft:
mean of the probability maps; hard: majority vote of the converted argmax
maps) and low-confidence pixels are set to ignore (255) with per-class
thresholds kc (CBST, `pseudo/cbst.py`).

Channel-major sources (the main path) feed the fused pass of
`ops/pseudo_cm.py`, a CUDA kernel on the card; NHWC sources take the plain
`fused_pseudo_pass` below.  PyTorch runs eagerly, so the JAX package's
compiled-program reuse has no counterpart: `set_variables` loads new weights
into a source's module in place and the next sweep uses them.

Not in this slice: the device mesh (data and model-axis parallelism) and
`use_pallas` (the pixel-major fused kernel); passing either raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from mspl_tpu_torch.data.label_space import label_conversion_matrix
from mspl_tpu_torch.data.transforms import normalize as default_normalize
from mspl_tpu_torch.ops.pseudo_cm import fused_pseudo_cm
from mspl_tpu_torch.utils.flax_bridge import load_flax_variables
from mspl_tpu_torch.utils.registry import IGNORE_LABEL

_LATER = ("belongs to a later slice of the PyTorch port (this slice runs "
          "one device without a mesh)")


@dataclasses.dataclass
class SourceModel:
    """A source network packaged for the pseudo-label engine.

    `model` maps a normalized NCHW batch to channel-major logits
    [B, C_src, H, W]; with `channel_major=False` the source hands the engine
    NHWC logits instead.  `conversion` is the float32 [C_src, T+1] pooling
    table into the target space (last column: mass mapped to ignore).
    `in_channels` is the number of input channels the stem takes: an RGB-D
    target batch is sliced to it before the forward."""

    name: str
    model: nn.Module
    conversion: np.ndarray
    channel_major: bool = False
    compute_dtype: Optional[torch.dtype] = None
    in_channels: int = 3

    def __call__(self, imgs: torch.Tensor) -> torch.Tensor:
        if imgs.shape[1] > self.in_channels:
            imgs = imgs[:, : self.in_channels]
        out = self.model(imgs)
        return out if self.channel_major else out.permute(0, 2, 3, 1)


_AUTO = object()


def load_variables(model: nn.Module, variables) -> None:
    """Load weights into `model` in place: a flax `{"params",
    "batch_stats"}` tree of numpy arrays goes through `load_flax_variables`,
    anything else is a torch state dict."""
    if isinstance(variables, Mapping) and "params" in variables:
        load_flax_variables(model, variables)
    else:
        model.load_state_dict(variables)
    model.eval()


def make_source(name: str, model: nn.Module, variables, src_dataset: str,
                num_target: int = 3, channel_major: bool = False,
                in_channels: int = 3,
                conversion: Optional[np.ndarray] = None,
                compute_dtype=_AUTO, device="cuda") -> SourceModel:
    """Wrap a segmentation module (with `variables` loaded, when given) as a
    SourceModel on `device`, in eval mode.  `conversion` overrides the
    registry table of `src_dataset`; `compute_dtype` defaults to the
    model's own (None leaves this source out of the engine's shared
    input-cast vote)."""
    if variables is not None:
        load_variables(model, variables)
    model = model.to(device).eval()
    return SourceModel(
        name=name,
        model=model,
        conversion=(conversion if conversion is not None
                    else label_conversion_matrix(src_dataset, num_target)),
        channel_major=channel_major,
        compute_dtype=(getattr(model, "compute_dtype", None)
                       if compute_dtype is _AUTO else compute_dtype),
        in_channels=in_channels,
    )


def convert_probs(probs: torch.Tensor, conversion) -> torch.Tensor:
    """Pool source-space probabilities [..., C] into the target space."""
    mat = torch.as_tensor(np.asarray(conversion), dtype=probs.dtype,
                          device=probs.device)
    return torch.einsum("...s,st->...t", probs, mat)


def entropy_confidence(dist: torch.Tensor) -> torch.Tensor:
    """1 - H(dist) / ln(K) over the last axis (normalized anti-entropy)."""
    d = dist.to(torch.float32)
    xlogx = torch.where(d > 0, d * torch.log(torch.clamp(d, min=1e-30)),
                        torch.zeros_like(d))
    return 1.0 - (-xlogx.sum(dim=-1)) / float(np.log(dist.shape[-1]))


def _apply_kc(label, conf, kc, t, ignore_label):
    if kc is None:
        return label, conf
    kc_t = torch.broadcast_to(
        torch.as_tensor(kc, dtype=torch.float32, device=conf.device), (t,))
    safe = torch.where(label == ignore_label, 0, label)
    ignore = torch.full_like(label, ignore_label)
    return torch.where(conf >= kc_t[safe], label, ignore), conf


def fused_pseudo_pass(
    logits_list: Sequence[torch.Tensor],
    conversions: Sequence[np.ndarray],
    mode: str = "soft",
    kc=None,
    num_target: Optional[int] = None,
    min_agree: Optional[int] = None,
    ignore_label: int = IGNORE_LABEL,
    conf_mode: str = "prob",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse N NHWC logit tensors [B,H,W,C_m] into (label int32 [B,H,W],
    conf f32 [B,H,W]); the plain reference of the fused pass.

    soft: mean of the converted probability maps, conf = its max over the
    T target classes (entropy: 1 - H/ln(T+1) of the full T+1 map).  hard:
    one-hot votes of each model's converted argmax (the ignore column votes
    for nothing), label = vote argmax, ignore below `min_agree` (default a
    strict majority), conf = agreeing fraction (entropy: of the vote
    distribution with abstentions as ignore votes).  kc=None does not
    threshold at all (the fused kernel thresholds against 0 instead)."""
    if len(logits_list) != len(conversions) or not logits_list:
        raise ValueError("need N>=1 matching logits/conversion pairs")
    if conf_mode not in ("prob", "entropy"):
        raise ValueError(f"unknown conf_mode '{conf_mode}'")
    n_models = len(logits_list)
    t = int(np.asarray(conversions[0]).shape[1]) - 1
    if num_target is not None and num_target != t:
        raise ValueError(f"conversion target dim {t} != num_target {num_target}")

    if mode == "soft":
        acc = None
        for logits, mat in zip(logits_list, conversions):
            q = convert_probs(torch.softmax(logits.to(torch.float32), -1), mat)
            acc = q if acc is None else acc + q
        fused = acc / n_models
        label = torch.argmax(fused[..., :t], dim=-1).to(torch.int32)
        conf = (entropy_confidence(fused) if conf_mode == "entropy"
                else fused[..., :t].amax(dim=-1))
    elif mode == "hard":
        votes = None
        for logits, mat in zip(logits_list, conversions):
            q = convert_probs(torch.softmax(logits.to(torch.float32), -1), mat)
            lab_m = torch.argmax(q, dim=-1)  # may be t, the ignore column
            onehot = (lab_m[..., None] == torch.arange(
                t, device=q.device)).to(torch.float32)
            votes = onehot if votes is None else votes + onehot
        label = torch.argmax(votes, dim=-1).to(torch.int32)
        top = votes.amax(dim=-1)
        need = min_agree if min_agree is not None else (n_models // 2 + 1)
        if conf_mode == "entropy":
            ig = n_models - votes.sum(dim=-1, keepdim=True)
            conf = entropy_confidence(torch.cat([votes, ig], -1) / n_models)
        else:
            conf = top / n_models
        label = torch.where(top >= need, label,
                            torch.full_like(label, ignore_label))
    else:
        raise ValueError(f"unknown fusion mode '{mode}'")
    return _apply_kc(label, conf, kc, t, ignore_label)


class PseudoLabelGenerator:
    """The pseudo-label engine over a fixed set of sources on one device.

    Each call sweeps a loader of `{"image", "valid", "index"}` uint8 NHWC
    batches: normalize on the device, one cast to the sources' shared
    compute dtype, N forwards, the fused pass.  Labels leave the device as
    uint8 (the host re-widens them to int32).  One batch of host-to-device
    lookahead overlaps the next batch's upload with this batch's compute."""

    def __init__(
        self,
        sources: Sequence[SourceModel],
        mode: str = "soft",
        kc: Optional[np.ndarray] = None,
        normalize_fn: Optional[Callable] = None,
        ignore_label: int = IGNORE_LABEL,
        use_pallas: bool = False,
        mesh=None,
        conf_mode: str = "prob",
        min_agree: Optional[int] = None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(f"a device mesh {_LATER}")
        if use_pallas:
            raise NotImplementedError(
                f"use_pallas (the pixel-major fused kernel) {_LATER}")
        if mode not in ("soft", "hard"):
            raise ValueError(f"unknown fusion mode '{mode}'")
        if conf_mode not in ("prob", "entropy"):
            raise ValueError(f"unknown conf_mode '{conf_mode}'")
        if not sources:
            raise ValueError("need at least one source")
        self.channel_major = any(s.channel_major for s in sources)
        if self.channel_major and not all(s.channel_major for s in sources):
            raise ValueError("all sources must agree on channel_major")
        self.device = torch.device(device)
        self.sources = list(sources)
        for s in self.sources:
            s.model.to(self.device).eval()
        self.mode, self.conf_mode, self.min_agree = mode, conf_mode, min_agree
        self.ignore_label = ignore_label
        self.normalize_fn = normalize_fn or default_normalize
        self.conversions = [np.asarray(s.conversion, np.float32)
                            for s in self.sources]
        self.num_target = int(self.conversions[0].shape[1]) - 1
        self.kc = (None if kc is None else torch.as_tensor(
            np.asarray(kc, np.float32), device=self.device))
        # cast the normalized batch to the models' compute dtype once
        dtypes = {s.compute_dtype for s in self.sources
                  if s.compute_dtype is not None}
        self.common_dtype = dtypes.pop() if len(dtypes) == 1 else None
        self.fetch_u8 = self.num_target <= 255 and 0 <= ignore_label <= 255

    def set_variables(self, i: int, variables) -> None:
        """Load new weights (same shapes) into source i's module in place;
        the next sweep uses them."""
        load_variables(self.sources[i].model, variables)

    @torch.inference_mode()
    def batch_pass(self, imgs_u8: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One device batch uint8 [B,H,W,C] -> (label [B,H,W] uint8, or
        int32 when the labels do not fit a byte; conf f32 [B,H,W])."""
        imgs = self.normalize_fn(imgs_u8)
        if self.common_dtype is not None:
            imgs = imgs.to(self.common_dtype)
        logits = [s(imgs) for s in self.sources]
        if self.channel_major:
            lab, conf = fused_pseudo_cm(
                logits, self.conversions, self.kc, mode=self.mode,
                min_agree=self.min_agree, ignore_label=self.ignore_label,
                conf_mode=self.conf_mode)
        else:
            lab, conf = fused_pseudo_pass(
                logits, self.conversions, mode=self.mode, kc=self.kc,
                min_agree=self.min_agree, ignore_label=self.ignore_label,
                conf_mode=self.conf_mode)
        return (lab.to(torch.uint8) if self.fetch_u8 else lab), conf

    def _put(self, batch) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(batch["image"]))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def _prefetched(self, loader):
        """(host_batch, device_images) with one batch of lookahead: batch
        k+1's upload is issued before batch k is consumed."""
        it = iter(loader)
        try:
            cur = next(it)
        except StopIteration:
            return
        cur_dev = self._put(cur)
        for nxt in it:
            nxt_dev = self._put(nxt)
            yield cur, cur_dev
            cur, cur_dev = nxt, nxt_dev
        yield cur, cur_dev

    def __call__(self, loader, return_device: bool = False):
        """One sweep: (labels [N,H,W], confidences [N,H,W], indices [N]) in
        loader order.  Host path: int32 labels and f32 confidences as numpy.
        return_device=True keeps labels (uint8) and confidences on the
        device; only the indices come back as numpy."""
        labels, confs, indices = [], [], []
        for batch, imgs in self._prefetched(loader):
            lab, conf = self.batch_pass(imgs)
            valid = np.asarray(batch["valid"])
            if return_device:
                # the loader pads only the tail batch, as a suffix, so the
                # valid rows are a prefix
                nv = int(valid.sum())
                if not valid[:nv].all():
                    raise ValueError(
                        "return_device=True requires suffix-only batch "
                        "padding (valid rows as a prefix)")
                labels.append(lab[:nv])
                confs.append(conf[:nv])
                indices.append(np.asarray(batch["index"])[:nv])
                continue
            labels.append(lab.cpu().numpy().astype(np.int32)[valid])
            confs.append(conf.cpu().numpy()[valid])
            indices.append(np.asarray(batch["index"])[valid])
        if return_device:
            return (torch.cat(labels), torch.cat(confs),
                    np.concatenate(indices))
        return (np.concatenate(labels), np.concatenate(confs),
                np.concatenate(indices))


def generate_pseudo_labels(
    sources: Sequence[SourceModel],
    loader,
    mode: str = "soft",
    kc: Optional[np.ndarray] = None,
    normalize_fn: Optional[Callable] = None,
    ignore_label: int = IGNORE_LABEL,
    use_pallas: bool = False,
    mesh=None,
    conf_mode: str = "prob",
    min_agree: Optional[int] = None,
    return_device: bool = False,
    device="cuda",
):
    """Sweep a target-image loader once; see `PseudoLabelGenerator`."""
    gen = PseudoLabelGenerator(
        sources, mode=mode, kc=kc, normalize_fn=normalize_fn,
        ignore_label=ignore_label, use_pallas=use_pallas, mesh=mesh,
        conf_mode=conf_mode, min_agree=min_agree, device=device)
    return gen(loader, return_device=return_device)
