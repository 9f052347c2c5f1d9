"""Pseudo-label engine (port of mspl_tpu/pseudo/generate.py).

N source segmentation models run over a batch of unlabeled target images;
per pixel, each model's softmax is converted into the greenhouse label space
through its [C_src, T+1] pooling table, the converted maps are fused (soft:
mean of the probability maps; hard: majority vote of the converted argmax
maps) and low-confidence pixels are set to ignore (255) with per-class
thresholds kc (CBST, `pseudo/cbst.py`).

Channel-major sources (the main path) feed the fused pass of
`ops/pseudo_cm.py`, a CUDA kernel on the card, whatever `use_pallas` says.
NHWC sources take the plain `fused_pseudo_pass` (re-exported from
`ops/pseudo.py`), or with `use_pallas=True` the pixel-major kernel of
`ops/pseudo.py`; that route first copies each source's NHWC view
(`SourceModel(channel_major=False)` permutes the model's NCHW logits) into
the contiguous layout the kernel reads, a copy flax's NHWC models never
pay.  PyTorch runs eagerly, so the JAX package's compiled-program reuse has
no counterpart: `set_variables` loads new weights into a source's module in
place and the next sweep uses them.

Not in this slice: the device mesh (data and model-axis parallelism);
passing one raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from mspl_tpu_torch.data.label_space import label_conversion_matrix
from mspl_tpu_torch.data.transforms import normalize as default_normalize
from mspl_tpu_torch.ops.pseudo import fused_pseudo_pass_plain as \
    fused_pseudo_pass  # the reference pass, under the JAX package's name
from mspl_tpu_torch.ops.pseudo import fused_pseudo_pass_pm
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
        # channel-major sources take the channel-major kernel whatever the
        # flag says, as in the JAX package
        self.use_pallas = bool(use_pallas) and not self.channel_major
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
        elif self.use_pallas:
            lab, conf = fused_pseudo_pass_pm(
                [x.contiguous() for x in logits], self.conversions,
                mode=self.mode, kc=self.kc, min_agree=self.min_agree,
                ignore_label=self.ignore_label, conf_mode=self.conf_mode)
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
