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
pay.

On a CUDA device each source's eval forward replays from a CUDA graph
(`ops/graphs.py`): one graph per source and input (shape, dtype, device).
A key's first batch runs the forward eagerly.  Its second runs it eagerly
again, which warms cuDNN and the kernels' plan caches (a capture may not
make their host-to-device copies), and right after captures it; every
later batch only replays.  The normalized batch is copied into one static
input that every source reads, and each source's logits stay in its
graph's output, which the fused pass reads before the next replay writes
it.  The graphs share one pool and are captured in the sources' order.
The tables cached on a module (⑤'s taps, ⑥'s packs) live as long as its
weights, which only `set_variables` may load; it drops the source's
graphs, and its next two batches run eagerly and capture again.  CPU
tensors never capture, and training never comes here.

With a mesh (`parallel/mesh.py`) every rank of the job sweeps the same
loader.  On the data axis each rank runs the whole per-batch pass above on
its contiguous slice of every batch, as the JAX package's `shard_map`
does.  On the model axis (M > 1) model slice i runs `sources[i::M]` on its
data slice, each source's softmax, conversion and soft sum or hard vote
in f32 plain torch, as the JAX package computes them there outside any
kernel; the sums are added over the model axis, then the shared soft or
hard epilogue and kc run on every slice.  The data axis's rows are then
gathered (`gather_rows`), and ranks outside the mesh receive them by
broadcast, so every rank returns every image's label and confidence in
loader order.

`fused_pseudo_soft_decoder_res` is the opt-in soft fusion at the decoder's
resolution, for `final_resize=False` models: softmax, conversion and the
mean at H/2 x W/2, then one resize of the fused (T+1)-channel map.  It is
plain torch, as the JAX function is plain XLA; the models' decoder still
runs the fused tail kernel, and the logits resize kernel does not run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from mspl_tpu_torch.data.label_space import label_conversion_matrix
from mspl_tpu_torch.data.transforms import normalize as default_normalize
from mspl_tpu_torch.ops import graphs
from mspl_tpu_torch.ops.pseudo import fused_pseudo_pass_plain as \
    fused_pseudo_pass  # the reference pass, under the JAX package's name
from mspl_tpu_torch.ops.pseudo import (apply_kc, entropy_confidence,
                                       fused_pseudo_pass_pm, fusion_epilogue,
                                       fusion_term)
from mspl_tpu_torch.ops.pseudo_cm import fused_pseudo_cm
from mspl_tpu_torch.ops.resize import resize_bilinear_cm
from mspl_tpu_torch.parallel.mesh import (Mesh, gather_rows, psum,
                                          replicate, shard_batch)
from mspl_tpu_torch.utils.flax_bridge import load_variables
from mspl_tpu_torch.utils.profiling import span
from mspl_tpu_torch.utils.registry import IGNORE_LABEL


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


def fused_pseudo_soft_decoder_res(
    logits_cm: Sequence[torch.Tensor],
    conversions: Sequence[np.ndarray],
    out_hw: Tuple[int, int],
    kc=None,
    ignore_label: int = IGNORE_LABEL,
    conf_mode: str = "prob",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft fusion at the decoder's resolution (an opt-in approximation).

    The exact pipeline resizes every model's C_src logits to the input's
    resolution before the softmax, as the reference does.  This variant
    takes channel-major logits [B, C_m, h, w] of `final_resize=False`
    models, softmaxes, converts into the target space and averages there
    (a quarter of the pixels), then resizes the fused [B, T+1, h, w] map
    to `out_hw` (align_corners bilinear, channel-major, H then W).  A
    bilinear resize is a convex combination, so the resized map is still a
    distribution; the label / confidence epilogue (argmax and max over the
    T target columns, or 1 - H / ln(T+1) over all T+1) and kc follow at
    full resolution.  It differs from the exact path where interpolation
    and softmax do not commute: at class boundaries.  Returns (label
    int32 [B, H, W], conf f32 [B, H, W])."""
    if not logits_cm or len(logits_cm) != len(conversions):
        raise ValueError("need N>=1 matching logits/conversion pairs")
    if conf_mode not in ("prob", "entropy"):
        raise ValueError(f"unknown conf_mode '{conf_mode}'")
    t = int(np.asarray(conversions[0]).shape[1]) - 1
    acc = None
    for lg, mat in zip(logits_cm, conversions):
        p = torch.softmax(lg.to(torch.float32), dim=1)
        tab = torch.as_tensor(np.asarray(mat, np.float32), device=lg.device)
        q = torch.einsum("bchw,ct->bthw", p, tab)
        acc = q if acc is None else acc + q
    fused = acc / len(logits_cm)
    up = resize_bilinear_cm(fused, out_hw, align_corners=True)
    tgt = up[:, :t]
    label = torch.argmax(tgt, dim=1).to(torch.int32)
    if conf_mode == "entropy":
        conf = entropy_confidence(up.movedim(1, -1))
    else:
        conf = tgt.amax(dim=1)
    return apply_kc(label, conf, kc, t, ignore_label)


_AUTO = object()


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
    """The pseudo-label engine over a fixed set of sources on one device,
    or with `mesh` on each rank of a mesh (module docstring).

    Each call sweeps a loader of `{"image", "valid", "index"}` uint8 NHWC
    batches: normalize on the device, one cast to the sources' shared
    compute dtype, N forwards, the fused pass.  Labels leave the device as
    uint8 (the host re-widens them to int32).  One batch of host-to-device
    lookahead overlaps the next batch's upload with this batch's compute.
    Under a mesh a rank moves to its device only the sources it runs.
    Under a profiler the upload is the span `mspl.generate.put`, each
    source's forward `mspl.generate.model:<its name>` and a replay of its
    graph `mspl.generate.replay:<its name>` inside it
    (`utils/profiling.py`).  `graph_captures`, `graph_replays` and
    `eager_forwards` count the sources' forwards by how they ran."""

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
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(f"mesh must be a parallel.Mesh, got "
                             f"{type(mesh).__name__}")
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
        self.span_names = [f"mspl.generate.model:{s.name}"
                           for s in self.sources]
        self.replay_names = [f"mspl.generate.replay:{s.name}"
                             for s in self.sources]
        # the forwards' CUDA graphs (module docstring): per input key
        # (shape, dtype, device), source index -> graphs.Captured
        self.graph_captures = self.graph_replays = self.eager_forwards = 0
        self._graphs = {}
        self._seen = set()  # (source index, input key) run eagerly once
        self._inputs = {}   # input key -> the static input
        self._pool = graphs.Pool()
        self.mesh = mesh
        # the sources this rank runs: all of them, those of its model
        # slice, or none outside the mesh
        self.mine = list(range(len(self.sources)))
        if mesh is not None:
            self.mine = ([] if mesh.coords is None else
                         self.mine[mesh.index("model")::mesh.shape["model"]])
        self.model_axis = mesh is not None and mesh.shape["model"] > 1
        for i in self.mine:
            self.sources[i].model.to(self.device).eval()
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
        the next sweep uses them.  Its graphs, which may read the old
        weights, go: its next two batches of each shape run eagerly, and
        the second captures again."""
        load_variables(self.sources[i].model, variables)
        for replays in self._graphs.values():
            replays.pop(i, None)
        self._seen = {w for w in self._seen if w[0] != i}

    def _static(self, imgs: torch.Tensor) -> torch.Tensor:
        """On a card, `imgs` copied into the static input of its key, which
        every source's forward and graph read; elsewhere `imgs`."""
        if not graphs.graphable(imgs):
            return imgs
        key = (tuple(imgs.shape), imgs.dtype, imgs.device)
        static = self._inputs.get(key)
        if static is None:
            static = self._inputs[key] = torch.empty_like(imgs)
        return static.copy_(imgs)

    def _forward(self, i: int, imgs: torch.Tensor) -> torch.Tensor:
        """Source i's eval forward on `imgs` (a static input on a card):
        eager on the CPU and on the first two batches of its key, the
        second followed by the capture, replayed from then on (module
        docstring)."""
        s = self.sources[i]
        if not graphs.graphable(imgs):
            self.eager_forwards += 1
            return s(imgs)
        key = (tuple(imgs.shape), imgs.dtype, imgs.device)
        replays = self._graphs.setdefault(key, {})
        rep = replays.get(i)
        if rep is None:
            self.eager_forwards += 1
            out = s(imgs)
            if (i, key) in self._seen:
                self._capture(i, imgs, replays)
            self._seen.add((i, key))
            return out
        with span(self.replay_names[i]):
            out = rep.replay()
        self.graph_replays += 1
        return out

    def _capture(self, i: int, static: torch.Tensor, replays) -> None:
        """Capture source i's forward on `static` into the shared pool,
        right after an eager forward on the same batch warmed it up."""
        # the pool's graphs replay in the order of their captures
        # (`graphs.Pool`), so later sources' graphs go and capture again
        for j in [j for j in replays if j > i]:
            del replays[j]
        s = self.sources[i]
        replays[i] = self._pool.capture(lambda: s(static),
                                        graphs.kept(s.model))
        self.graph_captures += 1

    @torch.inference_mode()
    def batch_pass(self, imgs_u8: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One device batch uint8 [B,H,W,C] -> (label [B,H,W] uint8, or
        int32 when the labels do not fit a byte; conf f32 [B,H,W])."""
        imgs = self.normalize_fn(imgs_u8)
        if self.common_dtype is not None:
            imgs = imgs.to(self.common_dtype)
        imgs = self._static(imgs)
        logits = []
        for i, name in enumerate(self.span_names):
            with span(name):
                logits.append(self._forward(i, imgs))
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

    @torch.inference_mode()
    def model_axis_pass(self, imgs_u8: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`batch_pass` on a model slice of the mesh: this slice's sources'
        fusion terms (f32, plain torch), their sum over the model axis, the
        epilogue and kc."""
        imgs = self.normalize_fn(imgs_u8)
        if self.common_dtype is not None:
            imgs = imgs.to(self.common_dtype)
        imgs = self._static(imgs)
        b, h, w = imgs_u8.shape[:3]
        t = self.num_target
        width = t + 1 if self.mode == "soft" else t
        acc = torch.zeros((b, h, w, width), dtype=torch.float32,
                          device=self.device)
        for i in self.mine:
            s = self.sources[i]
            with span(self.span_names[i]):
                lg = self._forward(i, imgs)
            if s.channel_major:
                lg = lg.permute(0, 2, 3, 1)
            acc = acc + fusion_term(lg, self.conversions[i], self.mode)
        psum(acc, self.mesh, "model")
        lab, conf = fusion_epilogue(acc, len(self.sources), self.mode,
                                    self.min_agree, self.ignore_label,
                                    self.conf_mode)
        lab, conf = apply_kc(lab, conf, self.kc, t, self.ignore_label)
        return (lab.to(torch.uint8) if self.fetch_u8 else lab), conf

    def _mesh_pass(self, batch, imgs):
        """This rank's share of a global batch on the mesh, then every
        row: (label, conf) of the whole batch on this rank's device."""
        mesh = self.mesh
        if mesh.coords is not None:
            run = self.model_axis_pass if self.model_axis else self.batch_pass
            lab, conf = run(imgs)
            lab = gather_rows(lab, mesh, "data")
            conf = gather_rows(conf, mesh, "data")
        else:
            shape = np.asarray(batch["image"]).shape[:3]
            lab = torch.zeros(shape, device=self.device, dtype=(
                torch.uint8 if self.fetch_u8 else torch.int32))
            conf = torch.zeros(shape, device=self.device)
        if mesh.has_outside:
            replicate({"label": lab, "conf": conf}, mesh)
        return lab, conf

    def _put(self, batch) -> Optional[torch.Tensor]:
        """The batch's images on the device: under a mesh this rank's data
        slice of them, None outside the mesh."""
        if self.mesh is not None and self.mesh.coords is None:
            return None
        with span("mspl.generate.put"):
            images = batch["image"]
            if self.mesh is not None:
                images = shard_batch({"image": images}, self.mesh)["image"]
            host = torch.from_numpy(np.ascontiguousarray(images))
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
            lab, conf = (self.batch_pass(imgs) if self.mesh is None
                         else self._mesh_pass(batch, imgs))
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
    """Sweep a target-image loader once; see `PseudoLabelGenerator` (with
    `mesh`, every rank of the job calls this with the same loader)."""
    gen = PseudoLabelGenerator(
        sources, mode=mode, kc=kc, normalize_fn=normalize_fn,
        ignore_label=ignore_label, use_pallas=use_pallas, mesh=mesh,
        conf_mode=conf_mode, min_agree=min_agree, device=device)
    return gen(loader, return_device=return_device)
