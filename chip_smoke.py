#!/usr/bin/env python3
"""Drive the PyTorch port's pseudo-label main path on one CUDA card.

    python3 chip_smoke.py [--batches N] [--profile DIR]

Phases (each prints a line; any failure raises and exits non-zero):
  1. device: refuse to run without CUDA; print the card's name and power
     limit; fp32 checks run with TF32 off.
  2. build: compile every CUDA kernel of mspl_tpu_torch/csrc with nvcc,
     one process per source, all at once.
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes (fp32 first, then bf16; the fused pass, the branch
     stack, the pyramid-pool tail and the logits resize also at odd shapes
     off the main path; both fused passes also on a self-training round's
     mixed ensemble, 3 bf16 sources and an f32 3-class model, timed at the
     round's batch), the tail's band widths and blocks per SM, then
     each kernel's time at batch 128 (the branch stack's also plane by
     plane) beside the plain version's, a library call's where one
     computes the same function, and its bound on an H100 (memory at
     3.35 TB/s, f32 arithmetic at 67 TFLOP/s, matrix products at the bf16
     tensor-core 989 TFLOP/s; the largest of the three).
  4. main path: three ESPNetv2-s2.0 sources in bf16 (CamVid 11, Cityscapes
     19, Forest 5 classes; random weights from a seed) at 256x480, batch
     128, through PseudoLabelGenerator (soft fusion, prob confidence,
     kc = 0.5), then the CBST histograms and kc; every kernel's launch
     count (0 for the encoder kernels and the pixel-major pass), img/s, a
     per-stage breakdown of one batch, and label agreement with the same
     generator on the plain versions.
  5. routes: the same sources and weights through the three other kernel
     routes at full width, each a timed sweep: the models with
     `use_pallas=True` (EESP branch kernel), with `fuse_stages=True`
     (fused-stage kernel), and NHWC sources with a `use_pallas=True`
     generator (pixel-major pass); img/s, a per-stage breakdown, the
     launch counts, and label agreement with the same generator on the
     plain versions and with the default route.
  6. train: one ESPNetv2-s2.0 greenhouse model (3 classes) at 256x480,
     batch 8, fp32, through the port's train step (SGD at the hybrid
     schedule, class weights from the labels): one step on the kernels
     against one step on the plain versions from the same weights (loss,
     every gradient, parameter and BatchNorm statistic), 20 steps on one
     fixed batch (the loss falls), ms a step, img/s and peak memory over
     10 timed steps with the branch kernel's launches (4 a step), the
     forward, backward and optimizer spans of a step, the branch kernel's
     forward beside its plain backward at the four decoder planes, and
     the eval step's confusion matrix.
  7. self-training: two rounds of `self_training` at full width (phase 4's
     bf16 sources, an f32 3-class ESPNetv2-s2.0 target model, 64
     synthetic target images and 16 labeled val images at 256x480,
     SelfTrainConfig's defaults but for 2 rounds of 1 epoch: 8 augmented
     steps a round, the target model in the ensemble from round 1): per
     round p, kc, kept share, val mIoU, generation / kc sweep / train /
     eval times and the launch counts; gated against the same rounds on
     the plain versions (label agreement per round, round 0's kc, the
     tuned model's parameters after round 0), held between three controls
     of the fine-tune.
The last line is {"ok": true, "device": {...}}; the line before it names
the card, and the one before that lists every kernel as JSON (the branch
kernel's row also carries its train launches, and every row its launches
in phase 7's two rounds).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from mspl_tpu_torch.data.label_space import label_conversion_matrix
from mspl_tpu_torch.data.loader import DataLoader
from mspl_tpu_torch.engine.losses import compute_class_weights
from mspl_tpu_torch.engine.metrics import iou_from_confusion
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import (create_train_state, make_eval_step,
                                         make_train_step)
from mspl_tpu_torch.layers.eesp import EESP, branch_dilations
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation, init_random
from mspl_tpu_torch.ops import (_cuda, eesp_branches, eesp_stage, pseudo,
                                pseudo_cm, pyrpool, resize_x2)
from mspl_tpu_torch.pseudo import generate
from mspl_tpu_torch.pseudo.cbst import (class_confidence_histograms,
                                        kc_from_histograms)

SOURCES = (("camvid", 11), ("cityscapes", 19), ("forest", 5))
HW = (256, 480)
BATCH = 128
SCALES = (2.0, 1.5, 1.0, 0.5, 0.1)
KC = 0.5
MEM_BPS = 3.35e12   # H100 SXM device memory
F32_OPS = 67e12     # H100 SXM f32 arithmetic outside the tensor cores
BF16_TC = 989e12    # H100 SXM dense bf16 tensor-core products
BF16_ULP = 2.0 ** -7
# the EESP units of one source: (C, r_lim, units, H, W) at 256x480
STAGES = ((256, 9, 3, 32, 60), (512, 7, 7, 16, 30))
# the DownSampler fronts of one source: (nin, n, H, W), dilations 1..4
FRONTS = ((32, 24, 128, 240), (128, 32, 64, 120), (256, 64, 32, 60))
SEED = 0


def proj_width(c: int) -> int:
    return min(16, max(c // 2, 8))  # the model's pyramid-pool width, bp=16


def bound(nbytes: float, ops: float, tc_ops: float = 0.0):
    """(ms, "bytes" or "operations", the limiting term): the largest of
    bytes at the memory rate, f32 work at the f32 rate, and matrix-product
    work at the bf16 tensor-core rate."""
    terms = [(nbytes / MEM_BPS * 1e3, "bytes", "bytes"),
             (ops / F32_OPS * 1e3, "operations", "f32 operations"),
             (tc_ops / BF16_TC * 1e3, "operations", "bf16 products")]
    return max(terms, key=lambda t: t[0])


def time_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name, got, want, atol, rtol=0.0) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bool((err > lim).any()):
        raise AssertionError(f"{name}: max |err| {err.max().item():.3g} "
                             f"beyond atol {atol} rtol {rtol}")
    return err.max().item()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's main path needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"phase 1 device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    return smi


def phase_build() -> None:
    secs = _cuda.build_all()
    regs = []
    for name in _cuda.SOURCES:
        log = (_cuda.BUILD / f"{name}.log")
        text = log.read_text(errors="replace") if log.exists() else ""
        used = [ln.split("Used", 1)[1].split(",")[0].strip()
                for ln in text.splitlines() if "Used" in ln]
        stack = [int(ln.split("bytes stack frame")[0].split()[-1])
                 for ln in text.splitlines() if "bytes stack frame" in ln]
        regs.append(f"{name}: {'; '.join(used) or 'cached'}"
                    + (f" (stack frame up to {max(stack)} bytes)"
                       if stack else ""))
    print(f"phase 2 build: {secs:.1f} s for {len(_cuda.SOURCES)} sources "
          f"(nvcc sm_90a, in parallel) | {' | '.join(regs)}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _rand(gen, shape, sd=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device="cuda") * sd).to(dtype)


def _affine(gen, n):
    u = lambda: torch.rand(n, generator=gen, device="cuda")  # noqa: E731
    return torch.stack([u() + 0.5, torch.randn(n, generator=gen,
                                               device="cuda") * 0.1,
                        u() * 0.5])


def pseudo_calls(b, dtype, gen, hw=HW):
    logits = [_rand(gen, (b, c, *hw), 2.0, dtype) for _, c in SOURCES]
    return [(logits,)]


# a pixel count that is not a multiple of 4: the fused pass's planes then
# start off a vector load's word and the kernel loads element by element
PSEUDO_ODD = (3, (17, 29))
# a self-training round's ensemble from round 1 on: the three bf16 sources
# and the f32 target model (3 classes, identity table), at the round's
# generation batch; its thresholds lie off the discrete confidences of 4
# votes (2 of 4 votes give 0.5 both as a share and as an entropy), where
# no pixel is decided
ROUND_BATCH = 8
MIXED_KC = (0.45, 0.55, 0.6)


def identity_table(t: int = 3) -> np.ndarray:
    return np.concatenate([np.eye(t, dtype=np.float32),
                           np.zeros((t, 1), np.float32)], axis=1)


def mixed_calls(b, gen, hw=HW, channel_last=False):
    """Logits of the round's mixed ensemble (bf16 sources, f32 target) and
    their tables."""
    shape = (lambda c: (b, *hw, c)) if channel_last else (
        lambda c: (b, c, *hw))
    logits = [_rand(gen, shape(c), 2.0, torch.bfloat16) for _, c in SOURCES]
    logits.append(_rand(gen, shape(3), 2.0, torch.float32))
    convs = [label_conversion_matrix(n) for n, _ in SOURCES]
    return logits, convs + [identity_table()]


def _pseudo_decided(logits, convs, mode, kc, conf, lbl_plain):
    """Pixels whose label no rounding can flip: top-2 margin of the fused
    (soft) or every per-model (hard) distribution above 1e-5, and the
    confidence more than 1e-5 away from the threshold of the class it
    votes for, unless too few models vote for that class (hard fusion's
    min_agree, which sets the label to ignore whatever the confidence)."""
    qs = []
    for x, c in zip(logits, convs):
        p = torch.softmax(x.float(), dim=1)
        qs.append(torch.einsum("bchw,ct->bthw", p,
                               torch.from_numpy(c).cuda()))
    t, n = convs[0].shape[1] - 1, len(qs)
    if mode == "soft":
        fused = sum(qs)[:, :t] / n
        top2 = torch.topk(fused, 2, dim=1).values
        margin = top2[:, 0] - top2[:, 1]
        label, voted = fused.argmax(1), torch.ones_like(margin, dtype=bool)
    else:
        margin = torch.stack([
            (lambda v: v[:, 0] - v[:, 1])(torch.topk(q, 2, dim=1).values)
            for q in qs]).amin(0)
        votes = sum(F.one_hot(q.argmax(1), t + 1)[..., :t] for q in qs)
        label, voted = votes.argmax(-1), votes.amax(-1) >= n // 2 + 1
    kc = torch.broadcast_to(torch.as_tensor(kc, device=conf.device), (t,))
    near = (conf - kc[label]).abs() <= 1e-5
    return (margin > 1e-5) & ~(voted & near)


FUSIONS = (("soft", "prob"), ("soft", "entropy"), ("hard", "prob"),
           ("hard", "entropy"))


def check_pseudo(gen):
    """fp32 and bf16 ensembles at the main path's shape and an odd one,
    and the round's mixed ensemble (bf16 sources, f32 target model; dtype
    "mixed") at its batch, every fusion and confidence, and at the odd
    shape."""
    src_convs = [label_conversion_matrix(n) for n, _ in SOURCES]
    kc_src = torch.full((3,), KC, device="cuda")
    kc_mixed = torch.tensor(MIXED_KC, device="cuda")
    errs = {}
    runs = [(torch.float32, combo, shape)
            for shape in ((8, HW), PSEUDO_ODD) for combo in FUSIONS]
    runs += [(torch.bfloat16, ("soft", "prob"), shape)
             for shape in ((8, HW), PSEUDO_ODD)]
    runs += [("mixed", combo, (ROUND_BATCH, HW)) for combo in FUSIONS]
    runs += [("mixed", ("soft", "prob"), PSEUDO_ODD)]
    for dtype, (mode, conf_mode), (b, hw) in runs:
        if dtype == "mixed":
            logits, convs = mixed_calls(b, gen, hw)
            kc = kc_mixed
        else:
            (logits,), = pseudo_calls(b, dtype, gen, hw)
            convs, kc = src_convs, kc_src
        got_l, got_c = pseudo_cm.fused_pseudo_cm(
            logits, convs, kc, mode=mode, conf_mode=conf_mode)
        want_l, want_c = pseudo_cm.fused_pseudo_cm_plain(
            logits, convs, kc, mode=mode, conf_mode=conf_mode)
        tag = f"fused_pseudo_cm {mode}/{conf_mode} {dtype} {b}x{hw}"
        err = check_close(tag, got_c, want_c, atol=1e-5)
        decided = _pseudo_decided(logits, convs, mode, kc, want_c, want_l)
        bad = int(((got_l != want_l) & decided).sum())
        if bad or decided.float().mean() < 0.99:
            raise AssertionError(f"{tag}: {bad} decided labels differ "
                                 f"({decided.float().mean():.4f} decided)")
        errs[dtype] = max(errs.get(dtype, 0.0), err)
    return errs


BRANCH_SHAPES = ((16, 30), (32, 60), (64, 120))  # bu_dec_l1..l3's planes


def branch_calls(b, dtype, gen):
    calls = []
    for _, c in SOURCES:
        p = proj_width(c)
        for h, w in BRANCH_SHAPES:
            calls.append((_rand(gen, (b, p, h, w), 1.0, dtype),
                          _rand(gen, (5, 3, 3, p), 0.5), SCALES))
    return calls


def branch_by_shape(calls):
    """The branch kernel's ms a batch at each of its planes (the three
    sources' calls at that shape), the least of two timings."""
    out = {}
    for hw in BRANCH_SHAPES:
        sub = [a for a in calls if tuple(a[0].shape[2:]) == hw]
        run = lambda: [pyrpool.pyr_branches(*a) for a in sub]  # noqa: E731
        out[hw] = min(time_ms(run), time_ms(run))
    return out


def tail_calls(b, dtype, gen):
    calls = []
    for _, c in SOURCES:
        p, s_n = proj_width(c), len(SCALES)
        calls.append((_rand(gen, (b, p, 128, 240), 1.0, dtype),
                      _rand(gen, (s_n, 3, 3, p), 0.5), _affine(gen, s_n * p),
                      _rand(gen, (3, 3, s_n, p), 0.3), _affine(gen, p),
                      _rand(gen, (p, c), 0.5), _rand(gen, (c,), 0.1),
                      torch.tensor([[1.0], [0.0], [1.0]]).repeat(1, c).cuda(),
                      SCALES))
    return calls


def resize_calls(b, dtype, gen):
    return [(_rand(gen, (b, c, 128, 240), 3.0, dtype), HW, True)
            for _, c in SOURCES]


# shapes off the main path, checked beside it: an odd plane whose 1.25
# scale takes the tail kernel's 6-wide band instance, and a tiny plane
# where the branch sizes' clamp to 5 bites (band 2, run as 3); resizes
# that are not x2 (odd sizes, a W that shrinks), whose rows start
# unaligned, so the kernel stores element by element
ODD_SCALES = (2.0, 1.25, 1.0, 0.5, 0.1)


def tail_odd_calls(dtype, gen):
    """The odd planes, and the classifier stage of phase 6's 3-class model
    (P 8, O 3) as its eval step runs it."""
    calls = []
    for (b, p, h, w, o), scales in (((2, 9, 37, 53, 7), ODD_SCALES),
                                    ((2, 8, 2, 3, 5), SCALES),
                                    ((8, 8, 128, 240, 3), SCALES)):
        s_n = len(scales)
        calls.append((_rand(gen, (b, p, h, w), 1.0, dtype),
                      _rand(gen, (s_n, 3, 3, p), 0.5), _affine(gen, s_n * p),
                      _rand(gen, (3, 3, s_n, p), 0.3), _affine(gen, p),
                      _rand(gen, (p, o), 0.5), _rand(gen, (o,), 0.1),
                      _affine(gen, o), scales))
    return calls


def branch_odd_calls(dtype, gen):
    """The branch stack at the tail's odd planes: spans that do not start on
    a 16-byte word (stored element by element) and a 6-wide band, and the
    tiny plane."""
    return [(_rand(gen, (b, p, h, w), 1.0, dtype),
             _rand(gen, (len(scales), 3, 3, p), 0.5), scales)
            for (b, p, h, w), scales in (((2, 9, 37, 53), ODD_SCALES),
                                         ((2, 8, 2, 3), SCALES))]


# the train step's branch-stack planes: bu_dec_l1..l4 of a 3-class model
# (P 8) at batch 8; 128x240 is the classifier stage, which the fused tail
# takes in eval
TRAIN_PLANES = ((16, 30), (32, 60), (64, 120), (128, 240))


def branch_train_calls(dtype, gen):
    return [(_rand(gen, (8, 8, h, w), 1.0, dtype),
             _rand(gen, (5, 3, 3, 8), 0.5), SCALES) for h, w in TRAIN_PLANES]


def resize_odd_calls(dtype, gen):
    """The odd resizes, and phase 6's eval step's 3-class logits."""
    return [(_rand(gen, (2, 5, 37, 53), 3.0, dtype), (101, 77), True),
            (_rand(gen, (3, 4, 20, 31), 3.0, dtype), (45, 16), True),
            (_rand(gen, (8, 3, 128, 240), 3.0, dtype), HW, True)]


def with_odd(make_calls, odd_calls):
    """The main path's calls and the odd shapes', for the checks only."""
    return lambda b, dtype, gen: make_calls(b, dtype, gen) + odd_calls(
        dtype, gen)


def check_elementwise(kernel, plain, make_calls, gen, atol32, name,
                      rtol32=0.0):
    """fp32 within atol32 (+ rtol32), bf16 within one bf16 rounding of the
    plain version (both compute in f32 and round once)."""
    err16 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for args in make_calls(8, dtype, gen):
            got, want = kernel(*args), plain(*args)
            if dtype == torch.float32:
                check_close(f"{name} fp32", got, want, atol=atol32,
                            rtol=rtol32)
            else:
                err16 = max(err16, check_close(f"{name} bf16", got, want,
                                               atol=1e-3, rtol=BF16_ULP))
    return err16


def _flat_outputs(fn):
    """One tensor of a function's outputs, for the elementwise check."""
    return lambda *a: torch.cat([t.reshape(-1) for t in fn(*a)])


# --- the encoder kernels and the pixel-major pass at the main path's shapes

def _he_taps(gen, k, n):
    return _rand(gen, (k, 3, 3, n), (2.0 / 9.0) ** 0.5)


def eesp_calls(b, dtype, gen):
    """The 10 stride-1 EESP branch stacks of each source: proj [B, n, H, W]
    with n = C / 4, taps [4, 3, 3, n], the unit's dilations."""
    calls = []
    for _ in SOURCES:
        for c, r_lim, units, h, w in STAGES:
            d = branch_dilations(4, r_lim)
            for _ in range(units):
                calls.append((_rand(gen, (b, c // 4, h, w), 1.0, dtype),
                              _he_taps(gen, 4, c // 4), d))
    return calls


def front_calls(b, dtype, gen):
    """The 3 DownSampler fronts of each source: x, proj, taps, dilations."""
    return [(_rand(gen, (b, nin, h, w), 1.0, dtype),
             _rand(gen, (b, n, h, w), 1.0, dtype), _he_taps(gen, 4, n),
             (1, 2, 3, 4))
            for _ in SOURCES for nin, n, h, w in FRONTS]


_stage_params_cache = {}


def stage_units(source: int):
    """Eval EESP units of one source at full width (random weights from a
    seed, BatchNorm statistics perturbed), folded once per source."""
    hit = _stage_params_cache.get(source)
    if hit is None:
        g = torch.Generator().manual_seed(SEED + 100 + source)
        hit = []
        for c, r_lim, units, _, _ in STAGES:
            mods = [init_random(EESP(c, c, k=4, r_lim=r_lim), g).eval()
                    for _ in range(units)]
            with torch.no_grad():
                for m in mods:
                    for name, buf in m.named_buffers():
                        if name.endswith("running_mean"):
                            buf.copy_(torch.randn(buf.shape, generator=g)
                                      * 0.3)
                        elif name.endswith("running_var"):
                            buf.copy_(torch.rand(buf.shape, generator=g)
                                      + 0.5)
            hit.append([eesp_stage.eesp_block_params(m.cuda())
                        for m in mods])
        _stage_params_cache[source] = hit
    return hit


def dense_stage_calls(b, dtype, gen):
    """A 2-unit K=3 chain [B, 24, 16, 24] whose expand is dense (n = 8 is
    not a multiple of K, so the units are not grouped): the kernel's
    dense-expand path, which ESPNetv2's K=4 stages never take."""
    hit = _stage_params_cache.get("dense")
    if hit is None:
        g = torch.Generator().manual_seed(SEED + 200)
        mods = [init_random(EESP(24, 24, k=3, r_lim=7), g).eval()
                for _ in range(2)]
        hit = [eesp_stage.eesp_block_params(m.cuda()) for m in mods]
        if hit[0]["ew"].dim() != 2:
            raise AssertionError("the K=3 chain should have a dense expand")
        _stage_params_cache["dense"] = hit
    return [(_rand(gen, (b, 24, 16, 24), 1.0, dtype), hit,
             branch_dilations(3, 7))]


def stage_calls(b, dtype, gen):
    """The 2 stride-1 stages of each source: x [B, C, H, W], the units'
    folded arrays, the stage's dilations."""
    calls = []
    for si in range(len(SOURCES)):
        for (c, r_lim, _, h, w), blocks in zip(STAGES, stage_units(si)):
            calls.append((_rand(gen, (b, c, h, w), 1.0, dtype), blocks,
                          branch_dilations(4, r_lim)))
    return calls


def check_stage(gen):
    """fp32 within the CPU tests' 5e-4 (rtol, and atol at the output's
    scale: random weights grow the activations through the residual chain,
    and the f32 ulp of a value in the hundreds is already ~1e-5, summed
    over products of hundreds of terms); bf16: both sides round the proj
    output and each unit's output once and sum in f32 in other orders, so a
    value near a rounding tie can land one bf16 ulp apart, and each unit
    passes such a difference on through its residual: after U units an
    output may differ by about U ulps.  The check allows (U + 1) ulps of
    |want| plus (U + 1) ulps of the output's rms.  The main path's stages
    come with a small dense-expand chain.  Returns the largest bf16 error
    and the largest output rms."""
    err16 = top_rms = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for x, blocks, d in (stage_calls(8, dtype, gen)
                             + dense_stage_calls(8, dtype, gen)):
            got = eesp_stage.eesp_stage_fused_eval(x, blocks, d)
            want = eesp_stage.eesp_stage_fused_eval_plain(x, blocks, d)
            rms = want.float().pow(2).mean().sqrt().item()
            top_rms = max(top_rms, rms)
            if dtype == torch.float32:
                check_close("eesp_stage fp32", got, want,
                            atol=5e-4 * max(1.0, rms), rtol=5e-4)
                continue
            tol = (len(blocks) + 1) * BF16_ULP
            err16 = max(err16, check_close("eesp_stage bf16", got, want,
                                           atol=tol * rms, rtol=tol))
    return err16, top_rms


def pm_calls(b, dtype, gen):
    return [([_rand(gen, (b, *HW, c), 2.0, dtype) for _, c in SOURCES],)]


def check_pm(gen):
    """The pixel-major pass against its plain version: confidences within
    1e-5, labels equal where no rounding can flip them; fp32, bf16, and
    the round's mixed ensemble.  Returns the largest confidence error of
    bf16 and of the mixed ensemble."""
    src_convs = [label_conversion_matrix(n) for n, _ in SOURCES]
    kc = torch.full((3,), KC, device="cuda")
    kc_mixed = torch.tensor(MIXED_KC, device="cuda")
    err16 = {}

    def every(k):
        return [(m, c, k) for m, c in FUSIONS] + [("soft", "prob", None)]

    for dtype, combos in ((torch.float32, every(kc)),
                          (torch.bfloat16, [("soft", "prob", kc)]),
                          ("mixed", every(kc_mixed))):
        if dtype == "mixed":
            logits, convs = mixed_calls(ROUND_BATCH, gen, channel_last=True)
        else:
            (logits,), = pm_calls(8, dtype, gen)
            convs = src_convs
        for mode, conf_mode, k in combos:
            got_l, got_c = pseudo.fused_pseudo_pass_pm(
                logits, convs, mode=mode, kc=k, conf_mode=conf_mode)
            want_l, want_c = pseudo.fused_pseudo_pass_plain(
                logits, convs, mode=mode, kc=k, conf_mode=conf_mode)
            tag = (f"fused_pseudo_pass_pm {mode}/{conf_mode}"
                   f"{'' if k is not None else '/no kc'} {dtype}")
            err = check_close(tag, got_c, want_c, atol=1e-5)
            decided = _pseudo_decided([x.permute(0, 3, 1, 2) for x in logits],
                                      convs, mode, k if k is not None
                                      else 0.0, want_c, want_l)
            bad = int(((got_l != want_l) & decided).sum())
            if bad or decided.float().mean() < 0.99:
                raise AssertionError(f"{tag}: {bad} decided labels differ "
                                     f"({decided.float().mean():.4f} decided)")
            if dtype != torch.float32:
                err16[dtype] = max(err16.get(dtype, 0.0), err)
    return err16


# --- operation and byte counts of one main-path batch (batch 128, bf16) ---

def pseudo_work(calls):
    (logits,), = calls
    b, _, h, w = logits[0].shape
    px, t, n = b * h * w, 3, len(logits)
    c_sum = sum(x.shape[1] for x in logits)
    nbytes = sum(x.numel() * x.element_size() for x in logits) + px * 8
    ops = px * (6 * c_sum + n * (t + 2) + 3 * t + 10)
    return nbytes, ops


def _branch_ops(b, p, h, w):
    ops = 0
    for (hs, ws), s in zip(pyrpool.branch_sizes(h, w, SCALES), SCALES):
        if s == 1.0:
            ops += 17 * h * w
            continue
        to = 9 * hs * ws if s > 1.0 else h * w + hs * ws
        ops += to + 17 * hs * ws + 9 * h * w
    return b * p * ops


def branch_work(calls):
    nbytes = ops = 0
    for x, wts, _ in calls:
        b, p, h, w = x.shape
        nbytes += x.numel() * x.element_size() * (1 + len(SCALES))
        nbytes += wts.numel() * 4
        ops += _branch_ops(b, p, h, w)
    return nbytes, ops


def tail_work(calls):
    nbytes = ops = 0
    for args in calls:
        x, o = args[0], args[5].shape[1]
        b, p, h, w = x.shape
        s_n = len(SCALES)
        nbytes += x.numel() * x.element_size() * (1 + o / p)
        nbytes += sum(t.numel() * 4 for t in args[1:8])
        ops += _branch_ops(b, p, h, w) + b * h * w * (
            24 * s_n * p + 6 * p + 2 * p * o + 7 * o)
    return nbytes, ops


def resize_work(calls):
    nbytes = ops = 0
    for x, (ho, wo), _ in calls:
        b, c = x.shape[:2]
        nbytes += x.numel() * x.element_size() + b * c * ho * wo * 2
        ops += 9 * b * c * ho * wo
    return nbytes, ops


def eesp_work(calls):
    nbytes = ops = 0
    for x, wts, d in calls:
        nbytes += x.numel() * x.element_size() * (1 + len(d)) + wts.numel() * 4
        ops += 19 * len(d) * x.numel()  # 9 multiply-adds + 1 HFF add
    return nbytes, ops


def front_work(calls):
    nbytes = ops = 0
    for x, proj, wts, d in calls:
        b, nin, h, w = x.shape
        n, k = proj.shape[1], len(d)
        h2, w2 = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        nbytes += (x.numel() + proj.numel() + b * (nin + k * n) * h2 * w2
                   ) * x.element_size() + wts.numel() * 4
        ops += b * h2 * w2 * (19 * k * n + 9 * nin)
    return nbytes, ops


def stage_work(calls):
    """Bytes: each stage's input read and output written once, plus the
    folded parameters.  Products (tensor-core work): the grouped proj and
    expand 1x1s.  f32 work per pixel and unit: taps and HFF 19C, proj bias
    + PReLU 4n, BR affine + PReLU 5C, expand bias + residual + PReLU 6C."""
    nbytes = ops = tc = 0
    for x, blocks, d in calls:
        b, c, h, w = x.shape
        px, n = b * h * w, c // len(d)
        nbytes += 2 * x.numel() * x.element_size()
        for blk in blocks:
            nbytes += sum(blk[a].numel() * 4 for a in (
                "pw", "paff", "taps", "cataff", "ew", "eaff", "alpha"))
            macs = n * c // blk["g_proj"] + (
                c * n if blk["ew"].dim() == 3 else c * c)
            tc += 2 * px * macs
            ops += px * (30 * c + 4 * n)
    return nbytes, ops, tc


def pm_work(calls):
    (logits,), = calls
    return pseudo_work([([x.permute(0, 3, 1, 2) for x in logits],)])


def print_mixed_times(gen):
    """Both fused passes at the round's generation batch: the mixed
    ensemble of round 1 on beside round 0's three bf16 sources, kernel and
    plain version, with the bound (bytes)."""
    kc = torch.full((3,), KC, device="cuda")
    parts = []
    for name, kern, plain, cl, fmt in (
            ("fused_pseudo_cm", pseudo_cm.fused_pseudo_cm,
             pseudo_cm.fused_pseudo_cm_plain, False, lambda x: x),
            ("fused_pseudo_pass_pm",
             lambda lg, cv, k: pseudo.fused_pseudo_pass_pm(lg, cv, kc=k),
             lambda lg, cv, k: pseudo.fused_pseudo_pass_plain(lg, cv, kc=k),
             True, lambda x: x.permute(0, 3, 1, 2))):
        mixed, convs = mixed_calls(ROUND_BATCH, gen, channel_last=cl)
        for what, logits, cv in (("mixed", mixed, convs),
                                 ("bf16 sources", mixed[:3], convs[:3])):
            k_ms = min(time_ms(lambda: kern(logits, cv, kc)) for _ in "ab")
            p_ms = time_ms(lambda: plain(logits, cv, kc))
            b_ms = bound(*pseudo_work([([fmt(x) for x in logits],)]))[0]
            parts.append(f"{name} {what}: kernel {k_ms:.4f}, plain "
                         f"{p_ms:.4f}, bound {b_ms:.4f}")
    print(f"phase 3 time at the round's batch ({ROUND_BATCH} x {HW[0]}x"
          f"{HW[1]}; ms): " + "; ".join(parts), flush=True)


def print_tail_layout(gen):
    """The tail kernel's band width per scale (the main path's plane and
    the odd ones) and its blocks per SM at the main path's calls."""
    bands = []
    for h, w, scales in ((128, 240, SCALES), (37, 53, ODD_SCALES),
                         (2, 3, SCALES)):
        ks = [rw.shape[2] for _, (_, rw), _ in
              pyrpool.scale_bands(h, w, scales)]
        bands.append(f"{h}x{w} " + ", ".join(
            f"{s}: {k}" for s, k in zip(scales, ks)))
    occ = [pyrpool.tail_blocks_per_sm(x, x.shape[1], cls_w.shape[1], sc)
           for x, _, _, _, _, cls_w, _, _, sc in
           tail_calls(1, torch.bfloat16, gen)]
    print("phase 3 pyr_pool_fused_eval layout: band K by scale ("
          + "; ".join(bands) + f") | blocks per SM {occ} of "
          f"{pyrpool.TAIL_THREADS} threads (cudaOccupancy"
          "MaxActiveBlocksPerMultiprocessor)", flush=True)


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err16 = {}
    errs = check_pseudo(gen)
    err16["fused_pseudo_cm"] = errs[torch.bfloat16]
    err16["pyr_branches"] = check_elementwise(
        pyrpool.pyr_branches, pyrpool.pyr_branches_plain,
        with_odd(branch_calls, lambda d, g: branch_odd_calls(d, g)
                 + branch_train_calls(d, g)), gen, 1e-4, "pyr_branches")
    err16["pyr_pool_fused_eval"] = check_elementwise(
        pyrpool.pyr_pool_fused_eval, pyrpool.pyr_pool_fused_eval_plain,
        with_odd(tail_calls, tail_odd_calls), gen, 1e-4,
        "pyr_pool_fused_eval")
    err16["resize_x2_cm"] = check_elementwise(
        resize_x2.resize_x2_cm, resize_x2.resize_x2_cm_plain,
        with_odd(resize_calls, resize_odd_calls), gen, 1e-5, "resize_x2_cm")
    err16["eesp_branches"] = check_elementwise(
        eesp_branches.eesp_branches, eesp_branches.eesp_branches_plain,
        eesp_calls, gen, 1e-5, "eesp_branches", rtol32=1e-5)
    err16["down_front"] = check_elementwise(
        _flat_outputs(eesp_branches.down_front),
        _flat_outputs(eesp_branches.down_front_plain), front_calls, gen,
        1e-5, "down_front", rtol32=1e-5)
    err16["eesp_stage_fused_eval"], stage_rms = check_stage(gen)
    pm_errs = check_pm(gen)
    err16["fused_pseudo_pass_pm"] = pm_errs[torch.bfloat16]
    mixed_err = {"fused_pseudo_cm": errs["mixed"],
                 "fused_pseudo_pass_pm": pm_errs["mixed"]}
    print("phase 3 kernels vs plain at batch 8: fp32 within atol (pseudo "
          "passes 1e-5 and labels equal where decided, branches (with the "
          "train step's planes up to 128x240) and tail (with the train "
          "model's 3-class classifier stage) 1e-4, resize (with its 3-class "
          "logits) 1e-5, EESP branches and DownSampler front 1e-5 + rtol "
          "1e-5, EESP stage 5e-4 + rtol 5e-4), bf16 within one bf16 "
          "rounding (EESP stage: units + 1 roundings of |want| and of the "
          f"rms; its outputs' rms up to {stage_rms:.4g}) | bf16 max |err| "
          + ", ".join(f"{k} {v:.3g}" for k, v in err16.items())
          + " | mixed ensemble (3 bf16 sources + 1 f32 3-class model, "
          f"batch {ROUND_BATCH}, every fusion and confidence; the fused pass "
          "also at the odd shape) max |conf err| " + ", ".join(
              f"{k} {v:.3g}" for k, v in mixed_err.items()), flush=True)
    print_tail_layout(gen)
    print_mixed_times(gen)

    convs = [label_conversion_matrix(n) for n, _ in SOURCES]
    kc = torch.full((3,), KC, device="cuda")

    def interp(x, size, ac):
        return F.interpolate(x, size=size, mode="bilinear", align_corners=ac)

    table = [
        ("fused_pseudo_cm", "mspl_tpu_torch/csrc/pseudo_cm.cuh",
         "mspl_tpu/ops/pallas_pseudo_cm.py:184", pseudo_calls, pseudo_work,
         lambda lg: pseudo_cm.fused_pseudo_cm(lg, convs, kc),
         lambda lg: pseudo_cm.fused_pseudo_cm_plain(lg, convs, kc), None),
        ("pyr_pool_fused_eval", "mspl_tpu_torch/csrc/pyrpool.cu",
         "mspl_tpu/ops/pallas_pyrpool.py:890", tail_calls, tail_work,
         pyrpool.pyr_pool_fused_eval, pyrpool.pyr_pool_fused_eval_plain,
         None),
        ("pyr_branches", "mspl_tpu_torch/csrc/pyrpool.cu",
         "mspl_tpu/ops/pallas_pyrpool.py:1224", branch_calls, branch_work,
         pyrpool.pyr_branches, pyrpool.pyr_branches_plain, None),
        ("resize_x2_cm", "mspl_tpu_torch/csrc/resize_x2.cu",
         "mspl_tpu/ops/pallas_resize.py:53", resize_calls, resize_work,
         resize_x2.resize_x2_cm, resize_x2.resize_x2_cm_plain, interp),
        ("eesp_branches", "mspl_tpu_torch/csrc/eesp_branches.cu",
         "mspl_tpu/ops/pallas_eesp.py:62", eesp_calls, eesp_work,
         eesp_branches.eesp_branches, eesp_branches.eesp_branches_plain,
         None),
        ("eesp_stage_fused_eval", "mspl_tpu_torch/csrc/eesp_stage.cu",
         "mspl_tpu/ops/pallas_eesp_stage.py:229", stage_calls, stage_work,
         eesp_stage.eesp_stage_fused_eval,
         eesp_stage.eesp_stage_fused_eval_plain, None),
        ("down_front", "mspl_tpu_torch/csrc/eesp_branches.cu",
         "mspl_tpu/ops/pallas_downsampler.py:183", front_calls, front_work,
         eesp_branches.down_front, eesp_branches.down_front_plain, None),
        ("fused_pseudo_pass_pm", "mspl_tpu_torch/csrc/pseudo_pm.cu",
         "mspl_tpu/ops/pallas_pseudo.py:108", pm_calls, pm_work,
         lambda lg: pseudo.fused_pseudo_pass_pm(lg, convs, kc=kc),
         lambda lg: pseudo.fused_pseudo_pass_plain(lg, convs, kc=kc), None),
    ]
    rows = []
    for name, src, replaces, make_calls, work, kern, plain, lib in table:
        calls = make_calls(BATCH, torch.bfloat16, gen)
        run = lambda f: (lambda: [f(*a) for a in calls])  # noqa: E731
        k_ms, p_ms = time_ms(run(kern)), time_ms(run(plain))
        k_ms = min(k_ms, time_ms(run(kern)))
        l_ms = None if lib is None else time_ms(run(lib))
        b_ms, b_by, term = bound(*work(calls))
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=0,
                         max_abs_err=err16[name], ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                         calls_per_batch=len(calls)))
        nbytes, *ops = work(calls)
        lib_txt = ("none (no one PyTorch call computes it)" if l_ms is None
                   else f"{l_ms:.3f} ms")
        work_txt = ", ".join([f"{nbytes / 1e9:.3f} GB"] + [
            f"{o / 1e9:.1f} GFLOP {kind}" for o, kind in
            zip(ops, ("f32", "bf16 products")) if o])
        print(f"phase 3 time {name} (batch {BATCH}, bf16, {len(calls)} "
              f"calls per main-path batch): kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, library {lib_txt}, bound {b_ms:.3f} ms "
              f"({term}; {work_txt})", flush=True)
        if name == "pyr_branches":
            print("phase 3 time pyr_branches by plane (ms a batch, the "
                  "three sources' calls): " + ", ".join(
                      f"{h}x{w} {ms:.3f}" for (h, w), ms in
                      branch_by_shape(calls).items()), flush=True)
        del calls
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

class SyntheticImages:
    """`n` uint8 target images served by `load_batch` from a pool of
    distinct images made in bulk from a seed (labels are unused)."""

    def __init__(self, n: int, images: np.ndarray):
        self.n, self.images = n, images
        self.labels = np.zeros((BATCH, *HW), np.int32)

    def __len__(self):
        return self.n

    def load_batch(self, indices):
        return (self.images[np.asarray(indices) % len(self.images)],
                self.labels[: len(indices)])


COUNTERS = {
    "fused_pseudo_cm": pseudo_cm.fused_pseudo_cm,
    "pyr_pool_fused_eval": pyrpool.pyr_pool_fused_eval,
    "pyr_branches": pyrpool.pyr_branches,
    "resize_x2_cm": resize_x2.resize_x2_cm,
}
PER_BATCH = {"fused_pseudo_cm": 1, "pyr_pool_fused_eval": 3,
             "pyr_branches": 9, "resize_x2_cm": 3}
# the kernels that only the other routes launch (phase 5); the DownSampler
# front is on no route
ROUTE_COUNTERS = {
    "eesp_branches": eesp_branches.eesp_branches,
    "eesp_stage_fused_eval": eesp_stage.eesp_stage_fused_eval,
    "down_front": eesp_branches.down_front,
    "fused_pseudo_pass_pm": pseudo.fused_pseudo_pass_pm,
}
ALL_COUNTERS = {**COUNTERS, **ROUTE_COUNTERS}


def _counts():
    """Every kernel's launch count."""
    return {k: fn.launches for k, fn in ALL_COUNTERS.items()}


@contextlib.contextmanager
def swapped(swaps):
    """Set each (module, name, value) of `swaps` for the block, then put
    every name back."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_kernels():
    """Route the model and the engine through the plain versions by name."""
    import mspl_tpu_torch.layers.eesp as le
    import mspl_tpu_torch.layers.pyramid_pool as pp
    import mspl_tpu_torch.models.espnetv2 as me

    swaps = [(pp, "pyr_branches", pyrpool.pyr_branches_plain),
             (pp, "pyr_pool_fused_eval", pyrpool.pyr_pool_fused_eval_plain),
             (me, "resize_x2_cm", resize_x2.resize_x2_cm_plain),
             (generate, "fused_pseudo_cm", pseudo_cm.fused_pseudo_cm_plain),
             (le, "eesp_branches", eesp_branches.eesp_branches_plain),
             (me, "eesp_stage_fused_eval",
              eesp_stage.eesp_stage_fused_eval_plain),
             (generate, "fused_pseudo_pass_pm",
              pseudo.fused_pseudo_pass_plain)]
    return swapped(swaps)


def breakdown(gen, imgs_u8):
    """CUDA-event times of one batch's stages (ms), as `gen.batch_pass`
    runs them; the pixel-major route's copy of the NHWC views into
    contiguous logits is its own stage."""
    marks = [("start", torch.cuda.Event(enable_timing=True))]

    def mark(name):
        marks.append((name, torch.cuda.Event(enable_timing=True)))
        marks[-1][1].record()

    with torch.inference_mode():
        marks[0][1].record()
        x = gen.normalize_fn(imgs_u8).to(gen.common_dtype)
        mark("normalize")
        logits = []
        for s in gen.sources:
            logits.append(s(x))
            mark(f"forward {s.name}")
        if gen.use_pallas:
            logits = [lg.contiguous() for lg in logits]
            mark("NHWC copy")
            pseudo.fused_pseudo_pass_pm(logits, gen.conversions, kc=gen.kc)
        else:
            pseudo_cm.fused_pseudo_cm(logits, gen.conversions, gen.kc)
        mark("fused pass")
    marks[-1][1].synchronize()
    return {name: a.elapsed_time(b) for (_, a), (name, b) in
            zip(marks, marks[1:])}


# the kernels of mspl_tpu_torch/csrc, by name
PORT_KERNELS = ("pseudo_cm_kernel", "pseudo_pm_kernel", "pyr_tail_kernel",
                "down_prepass_kernel", "pyr_branches_kernel",
                "resize_rows_kernel", "eesp_unit_kernel", "branches_kernel")


def profile_sweep(sweep, n_images: int, out_dir: str,
                  label: str = "phase 4") -> None:
    """torch.profiler over one sweep of `n_images`: the device's busy and
    idle share of the wall, the idle gaps over 0.3 ms with the host
    operations that overlap them, and the kernels that take the most device
    time; the full kernel table and a chrome trace go to `out_dir`."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(n_images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: e.self_device_time_total / 1e3  # noqa: E731
    busy = sum(dev_ms(e) for e in kernels)
    kernels.sort(key=dev_ms, reverse=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        for e in kernels:
            f.write(f"{dev_ms(e):10.3f} ms {e.count:6d}x  {e.key}\n")
    trace = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    gaps, end = [], spans[0][1]
    for a, b in spans[1:]:
        if a - end > 300:  # microseconds
            gaps.append((end, a))
        end = max(end, b)
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")
            and e.get("dur", 0) > 200]
    lines = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:5]:
        over = Counter()
        for e in host:
            lo, hi = max(e["ts"], a), min(e["ts"] + e["dur"], b)
            if hi > lo:
                over[e["name"][:40]] += (hi - lo) / 1e3
        lines.append(f"{(b - a) / 1e3:.2f} ms at +{(a - spans[0][0]) / 1e3:.1f}"
                     " ms (" + ", ".join(f"{n} {v:.1f}" for n, v in
                                         over.most_common(3)) + ")")
    print(f"{label} profile of a {n_images}-image sweep: wall {wall_ms:.2f} "
          f"ms, device busy {busy:.2f} ms ({busy / wall_ms:.3f} of wall, idle "
          f"{1 - busy / wall_ms:.3f}); largest idle gaps: "
          + ("; ".join(lines) or "none"), flush=True)
    print(f"{label} profile top kernels: " + "; ".join(
        f"{dev_ms(e):.2f} ms {e.count}x {e.key[:70]}" for e in kernels[:15]),
        flush=True)
    # the port's own kernels (csrc/), whatever their rank
    own = [e for e in kernels if e.key.split("<")[0].split("(")[0].split()[-1]
           in PORT_KERNELS]
    print(f"{label} profile port kernels: " + "; ".join(
        f"{dev_ms(e):.2f} ms {e.count}x {e.key.split('(')[0][:60]}"
        for e in own), flush=True)


def phase_main_path(n_batches: int, smi: str, profile_dir=None):
    g = torch.Generator().manual_seed(SEED)
    sources = []
    for name, c in SOURCES:
        model = init_random(ESPNetv2Segmentation(
            c, s=2.0, compute_dtype=torch.bfloat16), g)
        sources.append(generate.make_source(name, model, None, name,
                                            channel_major=True,
                                            device="cuda"))
    gen = generate.PseudoLabelGenerator(
        sources, mode="soft", kc=np.full(3, KC, np.float32),
        conf_mode="prob", device="cuda")
    pool = np.random.default_rng(SEED).integers(
        0, 256, (2 * BATCH, *HW, 3), dtype=np.uint8)
    n_images = BATCH * n_batches

    sweep = make_sweep(gen, pool)

    # warm-up: cuDNN plans, allocators (two pinned batches: the lookahead),
    # kernel libraries
    sweep(2 * BATCH)
    torch.cuda.synchronize()
    expect = {k: PER_BATCH.get(k, 0) for k in ALL_COUNTERS}
    labels, confs, hist, kc_next, secs, launches = timed_sweep(
        sweep, n_batches, expect)
    imgs_per_s = n_images / secs
    kept = check_sweep(labels, confs, hist, n_images)
    print(f"phase 4 main path: {n_batches} batches of {BATCH} at "
          f"{HW[0]}x{HW[1]}, 3 ESPNetv2-s2.0 sources bf16 -> "
          f"{imgs_per_s:.2f} img/s ({secs:.3f} s, host clock, sweep + "
          f"histograms + kc) on {smi} | launches {json.dumps(launches)} | "
          f"kept {kept / labels.numel():.4f} | next kc {kc_next.tolist()}",
          flush=True)
    del labels, confs

    imgs = torch.from_numpy(pool[:BATCH]).cuda()
    for _ in range(3):  # the last of three, after two warm ones
        stages = breakdown(gen, imgs)
    print("phase 4 one batch by stage (ms, CUDA events): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)

    lab_k, conf_k = gen.batch_pass(imgs)
    with plain_kernels():
        lab_p, conf_p = gen.batch_pass(imgs)
    agree = (lab_k == lab_p).float().mean().item()
    dconf = (conf_k - conf_p).abs().max().item()
    if agree < 0.995:
        raise AssertionError(f"kernel vs plain label agreement {agree:.5f}")
    print(f"phase 4 kernels vs plain versions over one batch: label "
          f"agreement {agree:.6f}, max |conf err| {dconf:.3g}", flush=True)
    if profile_dir:
        profile_sweep(sweep, n_images, profile_dir)
    return launches, imgs_per_s, gen, pool, lab_k


def make_sweep(gen, pool):
    def sweep(n):
        loader = DataLoader(SyntheticImages(n, pool), batch_size=BATCH,
                            num_workers=2)
        labels, confs, _ = gen(loader, return_device=True)
        hist = class_confidence_histograms(labels, confs, 3)
        return labels, confs, hist, kc_from_histograms(hist, 0.5)
    return sweep


def timed_sweep(sweep, n_batches: int, expect):
    """One sweep of `n_batches` with every launch count set to 0 just before
    it and read just after; raises unless each kernel launched `expect[k]`
    times a batch.  Returns the sweep's outputs, its seconds and the
    counts."""
    for fn in ALL_COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    labels, confs, hist, kc_next = sweep(BATCH * n_batches)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts()
    for k, per in expect.items():
        if launches[k] != per * n_batches:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{n_batches} batches, expected {per} each")
    return labels, confs, hist, kc_next, secs, launches


def check_sweep(labels, confs, hist, n_images: int) -> int:
    """Shapes, label values, confidences in [0, 1] and the histogram's
    total; returns the count of kept (non-ignore) pixels."""
    if labels.shape != (n_images, *HW) or labels.dtype != torch.uint8:
        raise AssertionError(f"labels {tuple(labels.shape)} {labels.dtype}")
    values = set(torch.unique(labels).tolist())
    if not values <= {0, 1, 2, 255}:
        raise AssertionError(f"label values {sorted(values)}")
    if not torch.isfinite(confs).all() or confs.min() < -1e-6 \
            or confs.max() > 1 + 1e-6:
        raise AssertionError("confidences not finite in [0, 1]")
    kept = int((labels != 255).sum())
    # the histogram keeps float32 counts: a bin above 2^24 rounds, so each
    # bin may be off by half its float32 ulp
    held = hist.double()
    if abs(held.sum().item() - kept) > (held * 2.0 ** -24).sum().item() + 0.5:
        raise AssertionError(f"histogram holds {held.sum().item()} of {kept}")
    return kept


# ---------------------------------------------------------------------------
# phase 5: the other kernel routes at full width
# ---------------------------------------------------------------------------

# name: (model flags, channel-major sources, generator use_pallas, the
# route's own kernel and its launches a batch: one per stride-1 unit for
# the branch and stage kernels, 3 sources x 10 units)
ROUTES = (
    ("use_pallas", dict(use_pallas=True), True, False,
     ("eesp_branches", 30)),
    ("fuse_stages", dict(fuse_stages=True), True, False,
     ("eesp_stage_fused_eval", 30)),
    ("nhwc_use_pallas", {}, False, True, ("fused_pseudo_pass_pm", 1)),
)


def phase_routes(n_batches: int, smi: str, gen_default, pool, lab_default,
                 profile_dir=None):
    """Each route's sources carry the default route's weights (the state
    dicts load unchanged into every flag combination)."""
    n_images = BATCH * n_batches
    imgs = torch.from_numpy(pool[:BATCH]).cuda()
    launches_of = {}
    for route, flags, cm, use_pallas, (kernel, per) in ROUTES:
        sources = []
        for (name, c), src in zip(SOURCES, gen_default.sources):
            model = ESPNetv2Segmentation(c, s=2.0,
                                         compute_dtype=torch.bfloat16,
                                         **flags)
            model.load_state_dict(src.model.state_dict())
            sources.append(generate.make_source(name, model, None, name,
                                                channel_major=cm,
                                                device="cuda"))
        gen = generate.PseudoLabelGenerator(
            sources, mode="soft", kc=np.full(3, KC, np.float32),
            conf_mode="prob", use_pallas=use_pallas, device="cuda")
        sweep = make_sweep(gen, pool)
        sweep(BATCH)  # warm-up: this route's kernels and plans
        torch.cuda.synchronize()
        expect = {k: 0 for k in ALL_COUNTERS}
        expect.update({k: v for k, v in PER_BATCH.items()
                       if cm or k != "fused_pseudo_cm"})
        expect[kernel] = per
        labels, confs, hist, kc_next, secs, launches = timed_sweep(
            sweep, n_batches, expect)
        kept = check_sweep(labels, confs, hist, n_images)
        launches_of[kernel] = launches[kernel]
        del labels, confs
        for _ in range(3):  # the last of three, after two warm ones
            stages = breakdown(gen, imgs)
        lab_k, _ = gen.batch_pass(imgs)
        with plain_kernels():
            lab_p, _ = gen.batch_pass(imgs)
        agree_p = (lab_k == lab_p).float().mean().item()
        agree_d = (lab_k == lab_default).float().mean().item()
        if min(agree_p, agree_d) < 0.995:
            raise AssertionError(
                f"route {route}: label agreement {agree_p:.5f} with the "
                f"plain versions, {agree_d:.5f} with the default route")
        print(f"phase 5 route {route}: {n_batches} batches of {BATCH} -> "
              f"{n_images / secs:.2f} img/s ({secs:.3f} s, host clock, sweep "
              f"+ histograms + kc) on {smi} | {kernel} {launches[kernel]} "
              f"launches ({per} a batch) | launches {json.dumps(launches)} | "
              f"kept {kept / (n_images * HW[0] * HW[1]):.4f} | label "
              f"agreement {agree_p:.6f} with the plain versions, "
              f"{agree_d:.6f} with the default route", flush=True)
        print(f"phase 5 route {route} one batch by stage (ms, CUDA events): "
              + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()),
              flush=True)
        if profile_dir and route == "fuse_stages":
            profile_sweep(sweep, n_images, os.path.join(profile_dir, route),
                          f"phase 5 route {route}")
        del gen, sources, sweep
    return launches_of


# ---------------------------------------------------------------------------
# phase 6: the train step
# ---------------------------------------------------------------------------

TRAIN_BATCH = 8      # the CLI's --batch-size default
TRAIN_CLASSES = 3    # greenhouse
TRAIN_STEPS = 20     # on one fixed batch: 3 warm-up, 10 timed, 7 more
# kernel step against plain step, both with cuDNN's deterministic
# algorithms: the loss, the gradients, the updates and the statistics
# follow the branch kernel's f32 rounding (1e-4 against its plain version)
# through the network.  Gradients are compared by tensor, relative to the
# tensor's norm and largest element; updated parameters relative to the
# tensor's largest update, past 2 ulps of the parameter; each with a floor
# of a thousandth of the model's largest, since some gradients are 0 in
# exact arithmetic and their computed values are rounding (a BatchNorm
# scale at zero bias whose output reaches a train-mode BatchNorm through
# PReLU and depthwise maps, all positively homogeneous, e.g. each EESP
# unit's proj_1x1).  Statistics relative (absolute below 1), the loss
# relative.  The check is held between two readings taken beside it, plain
# steps with the branch stack's output changed: perturbed by up to 1 ulp
# (a rounding, which must stay inside the limits), and rounded through bf16
# or with one scale's branches zeroed (a kernel in lower precision or with
# a branch lost, each of which must go beyond them).
TRAIN_TOL = dict(loss=1e-5, grad_norm=2e-2, grad_elem=2e-2, param=2e-2,
                 stats=1e-5)
FLOOR = 1e-3
# the share of valid pixels whose eval prediction may differ between the
# kernels and the plain versions (logits within 1e-4 move near-ties only)
EVAL_MOVED = 1e-4


def train_case():
    """A 3-class ESPNetv2-s2.0 (bp 16, proj 8) with random weights from a
    seed on the CPU, a uint8 batch of 8 at 256x480 with ~10% ignore, and
    class weights from its labels' histogram."""
    model = init_random(ESPNetv2Segmentation(TRAIN_CLASSES, s=2.0),
                        torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    images = rng.integers(0, 256, (TRAIN_BATCH, *HW, 3), dtype=np.uint8)
    labels = rng.integers(0, TRAIN_CLASSES, (TRAIN_BATCH, *HW)).astype(
        np.int32)
    labels[rng.random(labels.shape) < 0.1] = 255
    cw = compute_class_weights(np.bincount(labels[labels != 255],
                                           minlength=TRAIN_CLASSES))
    batch = {"image": torch.from_numpy(images).cuda(),
             "label": torch.from_numpy(labels).cuda()}
    return model, batch, cw


def train_state(model, cw):
    """SGD (momentum 0.9, weight decay 4e-5) at lr 0.009 on the hybrid
    schedule (the CLI's defaults) over TRAIN_STEPS steps, one a "epoch"."""
    model = copy.deepcopy(model).cuda()
    sched = build_schedule("hybrid", 0.009, TRAIN_STEPS)
    return (create_train_state(model, "sgd", sched),
            make_train_step(model, class_weights=cw))


def param_gaps(pa, pb, before):
    """Per parameter: the largest gap between `pa` and `pb` past 2 ulps of
    pb, relative to pb's largest update from `before`, floored at FLOOR of
    the model's largest update."""
    ups = {k: (pb[k] - before[k]).abs().max() for k in pb}
    u_floor = FLOOR * max(ups.values())
    return {k: ((pa[k] - pb[k]).abs() - 2.0 ** -22 * pb[k].abs()).clamp_min(
        0).max() / torch.maximum(ups[k], u_floor) for k in pb}


def update_gap(pa, pb, before) -> float:
    """|pa - pb| / |pb - before| over every parameter together: how far
    two fine-tunes' results lie apart, relative to how far the fine-tune
    moved the model (f64 sums)."""
    num = sum(((pa[k] - pb[k]).double() ** 2).sum() for k in pb)
    den = sum(((pb[k] - before[k]).double() ** 2).sum() for k in pb)
    return float((num / den).sqrt())


def _step_gaps(sa, sb, model0):
    """The gaps of TRAIN_TOL between two train states after one step from
    `model0`, and the parameter where each gradient gap peaks."""
    pa, pb = (dict(st.model.named_parameters()) for st in (sa, sb))
    before = {k: v.cuda() for k, v in model0.named_parameters()}
    grads = {k: (pa[k].grad, pb[k].grad) for k in pb}
    g_floor = FLOOR * max(g.abs().max() for _, g in grads.values())
    g_norm = FLOOR * max(g.norm() for _, g in grads.values())
    p_gaps = param_gaps(pa, pb, before)
    gaps = {"loss": 0.0, "grad_norm": 0.0, "grad_elem": 0.0, "param": 0.0,
            "stats": 0.0}
    where = {}
    for k, (ga, gb) in grads.items():
        for key, val in (
                ("grad_norm", (ga - gb).norm() / torch.maximum(gb.norm(),
                                                               g_norm)),
                ("grad_elem", (ga - gb).abs().max() / torch.maximum(
                    gb.abs().max(), g_floor)),
                ("param", p_gaps[k])):
            if val.item() > gaps[key]:
                gaps[key], where[key] = val.item(), k
    ba = dict(sa.model.named_buffers())
    for k, t in sb.model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            gap = ((ba[k] - t).abs() / t.abs().clamp_min(1.0)).max().item()
            gaps["stats"] = max(gaps["stats"], gap)
    return gaps, where


def _ulp_perturbed(fn, gen):
    """`fn` with its output multiplied by 1 + u * 2^-23, u uniform in
    [-1, 1) from `gen`: a rounding of up to 1 ulp, element by element."""
    def perturbed(*args):
        out = fn(*args)
        u = torch.rand(out.shape, generator=gen, device=out.device) * 2 - 1
        return out * (1 + u * 2.0 ** -23)
    return perturbed


def _bf16_rounded(fn):
    """`fn` with its output rounded through bf16 (2^-9 relative)."""
    return lambda *args: fn(*args).to(torch.bfloat16).to(torch.float32)


def _scale_dropped(fn):
    """`fn` with its last scale's branches (the last P channels) zeroed."""
    def dropped(x, *args):
        out = fn(x, *args)
        return torch.cat([out[:, :-x.shape[1]],
                          torch.zeros_like(out[:, -x.shape[1]:])], 1)
    return dropped


def train_controls():
    """The plain steps that the kernel step's check is held between:
    (name, branch stack, True where the check must see it)."""
    plain = pyrpool.pyr_branches_plain
    return (("1-ulp perturbed", _ulp_perturbed(
                plain, torch.Generator(device="cuda").manual_seed(SEED)),
             False),
            ("bf16-rounded", _bf16_rounded(plain), True),
            ("one scale dropped", _scale_dropped(plain), True))


def check_train_step(model0, batch, cw):
    """One step on the kernels, one on the plain versions and one for each
    of `train_controls()`, from the same weights and batch, with cuDNN's
    deterministic algorithms.  Returns the kernel step's gaps to the plain
    step, the parameters where they peak, each control's gaps, and the
    faults: the kernel step or the 1-ulp control beyond TRAIN_TOL, another
    control within it (the caller prints the gaps, then raises)."""
    import mspl_tpu_torch.layers.pyramid_pool as pp

    controls = train_controls()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    states = [train_state(model0, cw) for _ in range(2 + len(controls))]
    losses = []
    try:
        for i, (state, step) in enumerate(states):
            with plain_kernels() if i else contextlib.nullcontext():
                if i >= 2:
                    pp.pyr_branches = controls[i - 2][1]
                losses.append(step(state, batch)[1]["loss"].item())
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
    readings = []
    for i, (state, _) in enumerate(states):
        if i == 1:
            continue
        gaps, where = _step_gaps(state, states[1][0], model0)
        gaps["loss"] = abs(losses[i] - losses[1]) / abs(losses[1])
        readings.append((gaps, where))
    (gaps, where), ctrl = readings[0], {
        name: g for (name, _, _), (g, _) in zip(controls, readings[1:])}
    beyond = lambda g: any(g[k] > t for k, t in TRAIN_TOL.items())  # noqa
    faults = [f"the kernel step {gaps} (at {where})"] * (
        not np.isfinite(losses[0]) or beyond(gaps))
    faults += [f"the {name} step {ctrl[name]}" for name, _, seen in controls
               if beyond(ctrl[name]) != seen]
    return gaps, where, ctrl, faults


def branch_fwd_bwd(gen):
    """At each train plane (batch 8, P 8, fp32): the branch kernel's forward,
    its bound, and its backward (autograd through the recomputed plain
    version), ms each."""
    out = {}
    for (x, wts, scales), (h, w) in zip(
            branch_train_calls(torch.float32, gen), TRAIN_PLANES):
        g = torch.randn((x.shape[0], 5 * x.shape[1], h, w), device="cuda",
                        generator=gen)
        xr, wr = x.requires_grad_(), wts.requires_grad_()

        def bwd():
            torch.autograd.grad(pyrpool.pyr_branches_plain(xr, wr, scales),
                                (xr, wr), g)

        with torch.no_grad():
            fwd_ms = time_ms(lambda: pyrpool.pyr_branches(x, wts, scales))
        out[(h, w)] = (fwd_ms, bound(*branch_work([(x, wts, scales)]))[0],
                       time_ms(bwd))
    return out


def step_spans(state, step, batch):
    """CUDA-event times (ms) of one call of the train step `step`, split by
    hooks on its model and optimizer: forward (the model), backward (the
    loss, zero_grad, the backward and the lr) and the optimizer update."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    record = lambda e: (lambda *_: e.record())  # noqa: E731
    hooks = [state.model.register_forward_pre_hook(record(ev[0])),
             state.model.register_forward_hook(record(ev[1])),
             state.optimizer.register_step_pre_hook(record(ev[2])),
             state.optimizer.register_step_post_hook(record(ev[3]))]
    try:
        step(state, batch)
    finally:
        for h in hooks:
            h.remove()
    ev[3].synchronize()
    return {k: a.elapsed_time(b) for k, a, b in
            zip(("forward", "backward", "optimizer"), ev, ev[1:])}


def phase_train(smi: str, profile_dir=None):
    t_phase = time.perf_counter()
    model0, batch, cw = train_case()
    gaps, where, ctrl, faults = check_train_step(model0, batch, cw)
    fmt = lambda g: ", ".join(f"{k} {v:.3g}" for k, v in g.items())  # noqa
    print(f"phase 6 train: one step on the kernels against one on the plain "
          f"versions from the same weights and batch (cuDNN deterministic): "
          f"max gap " + ", ".join(f"{k} {v:.3g} (bound {TRAIN_TOL[k]})"
                                  for k, v in gaps.items())
          + f" at {json.dumps(where)}; plain steps with the branch stack's "
          "output changed, against the plain step: " + "; ".join(
              f"{name} {fmt(g)}" for name, g in ctrl.items())
          + " (loss relative; gradients relative to each tensor's norm and "
          "largest element, parameters to the tensor's largest update, each "
          f"floored at {FLOOR} of the model's largest; statistics "
          f"relative) on {smi}", flush=True)
    if faults:
        raise AssertionError(f"train step check against {TRAIN_TOL}: "
                             + "; ".join(faults) + " (the 1-ulp control must "
                             "be within, the others beyond)")

    state, step = train_state(model0, cw)
    losses = []
    for _ in range(3):  # warm-up: cuDNN plans, allocator, the kernel plans
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in ALL_COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = {k: 40 if k == "pyr_branches" else 0 for k in ALL_COUNTERS}
    if launches != expect:
        raise AssertionError(f"train launches {launches}, expected {expect}")
    while len(losses) < TRAIN_STEPS:
        state, m = step(state, batch)
        losses.append(m["loss"])
    losses = [v.item() for v in losses]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train losses {losses}")
    print(f"phase 6 train: {TRAIN_BATCH} x {HW[0]}x{HW[1]} fp32, "
          f"{TRAIN_CLASSES}-class ESPNetv2-s2.0: {secs * 100:.2f} ms a step, "
          f"{10 * TRAIN_BATCH / secs:.2f} img/s (10 timed steps after 3, "
          f"host clock to a synchronize), peak memory {peak:.3f} GiB, "
          f"pyr_branches {launches['pyr_branches'] / 10:g} launches a step "
          f"(every other kernel 0) on {smi}", flush=True)
    print(f"phase 6 train: loss over {TRAIN_STEPS} steps on one batch "
          f"(lr 0.009 hybrid): " + ", ".join(f"{v:.4f}" for v in losses),
          flush=True)
    if profile_dir:
        profile_sweep(lambda n: [step(state, batch)
                                 for _ in range(n // TRAIN_BATCH)],
                      3 * TRAIN_BATCH, os.path.join(profile_dir, "train"),
                      "phase 6 train")
    for _ in range(2):  # the last of two
        spans = step_spans(state, step, batch)
    print("phase 6 one step by span (ms, CUDA events): "
          + ", ".join(f"{k} {v:.2f}" for k, v in spans.items())
          + f" on {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    print("phase 6 pyr_branches at the train planes (batch 8, P 8, fp32; "
          "ms): " + ", ".join(
              f"{h}x{w} kernel forward {f:.3f} (bound {bd:.4f}), plain "
              f"backward {b:.3f}" for (h, w), (f, bd, b) in
              branch_fwd_bwd(gen).items())
          + f" on {smi}", flush=True)

    for fn in ALL_COUNTERS.values():
        fn.launches = 0
    eval_step = make_eval_step(state.model, TRAIN_CLASSES)
    cm = eval_step(batch)
    eval_launches = {k: ALL_COUNTERS[k].launches for k in
                     ("resize_x2_cm", "pyr_pool_fused_eval", "pyr_branches")}
    with plain_kernels():
        cm_plain = eval_step(batch)
    valid = int((batch["label"] != 255).sum())
    # each pixel whose prediction differs moves 1 out of one cell and into
    # another; only near-ties may move
    moved = int((cm - cm_plain).abs().sum().item()) // 2
    if cm.shape != (TRAIN_CLASSES,) * 2 or int(cm.sum().item()) != valid:
        raise AssertionError(f"eval confusion matrix holds {cm.sum().item()}"
                             f" of {valid} valid pixels")
    if moved > EVAL_MOVED * valid:
        raise AssertionError(f"eval step on the kernels against the plain "
                             f"versions: {moved} of {valid} pixels moved, "
                             f"beyond {EVAL_MOVED}")
    if eval_launches != {"resize_x2_cm": 1, "pyr_pool_fused_eval": 1,
                         "pyr_branches": 3}:
        raise AssertionError(f"eval step launches {eval_launches}")
    _, miou = iou_from_confusion(cm.cpu().numpy())
    print(f"phase 6 eval step: confusion matrix of {int(cm.sum().item())} "
          f"valid pixels (all of them), {moved} of them predicted otherwise "
          f"than by the same step on the plain versions (bound "
          f"{EVAL_MOVED} of them), mIoU {miou:.4f} after {state.step} steps, "
          f"launches {json.dumps(eval_launches)} on {smi} | phase 6 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches["pyr_branches"]


# ---------------------------------------------------------------------------
# phase 7: one self-training round at full width
# ---------------------------------------------------------------------------

ROUND_TARGET, ROUND_VAL = 64, 16   # unlabeled target images, labeled val
# SelfTrainConfig's defaults (SGD, poly lr 1e-3, kld 0.1, crop 256x480 at
# scales 0.7-1.3, batch 8, labels on the device) but for the length
ROUND_CFG = dict(rounds=2, epochs_per_round=1, verbose=False)
ROUND_STEPS = -(-ROUND_TARGET // ROUND_BATCH)  # train steps a round
ROUND_EVAL_BATCHES = -(-ROUND_VAL // ROUND_BATCH)
KC_BIN = 1.0 / 1024  # a CBST histogram bin
# share of round r's thresholded labels that must agree between the round
# on the kernels and the same round on the plain versions (both with
# cuDNN's deterministic algorithms); round 0 is generation only, round 1
# follows one fine-tune on each side.  Held between plain runs whose
# fine-tune alone takes another branch stack (`train_controls`): perturbed
# by 1 ulp (must stay inside) and with one scale dropped (round 1 must go
# beyond).  Set after the first run on an H100: the kernels 0.999956 and
# 0.999951, the 1-ulp control 1.0 and 0.999995, one scale dropped 1.0 and
# 0.899.  The labels cannot see a bf16-rounded fine-tune (round 1 read
# 0.999957): the parameter gap below gates it.
ROUND_AGREE = (0.999, 0.999)
LABELS_SEE = ("one scale dropped",)  # controls round 1's labels must see
# gap of the target model's parameters after round 0's fine-tune (8 steps)
# between a run and the plain one, |a - b| / |b - start| over all of them
# together (`update_gap`), held between the same controls: 1 ulp inside,
# bf16-rounded and one scale dropped beyond.  Set on an H100 between the
# sound runs' largest reading and the bf16 control's: kernels 0.00113,
# default cuDNN 0.00136, 1 ulp 0.000917; bf16-rounded 0.0111, one scale
# dropped 0.687.  After round 1 (16 steps, the labels differing) a
# rounding has grown to 1% (1 ulp 0.0100, kernels 0.0107, bf16 0.0235),
# so round 1's gap is printed, not gated.
ROUND_PARAM_TOL = 4e-3


class CachedSet:
    """A dataset's samples made once and served from memory (`load` for
    the pseudo-labeled set, `load_batch` for the loader)."""

    def __init__(self, ds):
        samples = [ds.load(i) for i in range(len(ds))]
        self.images = np.stack([x for x, _ in samples])
        self.labels = np.stack([y for _, y in samples])
        self.num_classes, self.shape_hw = ds.num_classes, ds.shape_hw

    def __len__(self):
        return len(self.images)

    def load(self, i):
        return self.images[i], self.labels[i]

    def load_batch(self, indices):
        return self.images[indices], self.labels[indices]


def round_probes(rec):
    """Time what a round runs and catch its thresholded labels: the
    generator's sweep, the kc sweep and re-threshold, the fine-tune (less
    its evaluations) and the evaluations, each between two synchronizes,
    into `rec["rounds"][r]`, with the launch counts at each round's start
    and the labels as they enter the pseudo-labeled dataset."""
    import mspl_tpu_torch.engine.train as et
    import mspl_tpu_torch.pseudo.self_training as st

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            cur = rec["rounds"][-1]
            cur[name] = cur.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    class Generator(st.PseudoLabelGenerator):
        def __call__(self, loader, return_device=False):
            rec["rounds"].append({"start": time.perf_counter(),
                                  "launches": _counts(),
                                  "n_models": len(self.sources)})
            return timed("generate", super().__call__)(loader, return_device)

    class Caught(st.PseudoLabeledDataset):
        def __init__(self, base_ds, labels, indices):
            rec["rounds"][-1]["labels"] = labels.astype(np.uint8)
            super().__init__(base_ds, labels, indices)

    train = timed("train", st.train_segmentation)

    def tuned(model, *args, **kwargs):
        out = train(model, *args, **kwargs)
        rec["rounds"][-1]["params"] = {
            k: v.detach().clone() for k, v in model.named_parameters()}
        return out

    swaps = [(st, "PseudoLabelGenerator", Generator),
             (st, "sweep_kc", timed("kc", st.sweep_kc)),
             (st, "apply_kc_device", timed("kc", st.apply_kc_device)),
             (st, "PseudoLabeledDataset", Caught),
             (st, "train_segmentation", tuned),
             (et, "evaluate", timed("eval", et.evaluate))]
    return swapped(swaps)


def _train_only(fn):
    """`fn` where autograd records (the fine-tune's forward), the plain
    branch stack elsewhere (generation and evaluation run in inference
    mode): a control that changes only what the fine-tune computes."""
    plain = pyrpool.pyr_branches_plain
    return lambda *a: fn(*a) if torch.is_grad_enabled() else plain(*a)


def run_rounds(sources, target0, target_set, val_set, plain=False,
               branch=None, deterministic=False):
    """Two self-training rounds from `target0`'s weights on the card, the
    launch counts set to 0 just before and read just after; on the plain
    versions with `plain`, with `branch` for the branch stack (inside
    `plain_kernels()`), with cuDNN's deterministic algorithms where asked.
    Returns the probes' record with the history, the launches and the
    seconds."""
    import mspl_tpu_torch.layers.pyramid_pool as pp
    import mspl_tpu_torch.pseudo.self_training as st

    rec = {"rounds": []}
    model = copy.deepcopy(target0)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        with (plain_kernels() if plain else contextlib.nullcontext()), \
                round_probes(rec):
            if branch is not None:
                pp.pyr_branches = branch
            for fn in ALL_COUNTERS.values():
                fn.launches = 0
            t0 = time.perf_counter()
            res = st.self_training(
                model, None, sources, target_set,
                DataLoader(val_set, batch_size=ROUND_BATCH), 3,
                st.SelfTrainConfig(**ROUND_CFG), device="cuda")
            torch.cuda.synchronize()
            end = time.perf_counter()
            rec["launches"] = _counts()
    finally:
        torch.backends.cudnn.deterministic = saved
    rec["secs"] = end - t0
    rec["history"] = res["history"]
    starts = [r["start"] for r in rec["rounds"]] + [end]
    marks = [r["launches"] for r in rec["rounds"]] + [rec["launches"]]
    for i, r in enumerate(rec["rounds"]):
        r["secs"] = starts[i + 1] - starts[i]
        r["launches"] = {k: marks[i + 1][k] - marks[i][k] for k in marks[i]}
    return rec


def round_expected(n_models: int):
    """Launches of one round: a batch of generation runs each model's three
    branch stacks, tail and resize and one fused pass; a train step the
    branch stack 4 times; an eval batch the 3-class model's 3, 1 and 1."""
    n_gen = ROUND_TARGET // ROUND_BATCH
    return {k: 0 for k in ALL_COUNTERS} | {
        "fused_pseudo_cm": n_gen,
        "pyr_branches": n_gen * 3 * n_models + 4 * ROUND_STEPS
        + 3 * ROUND_EVAL_BATCHES,
        "pyr_pool_fused_eval": n_gen * n_models + ROUND_EVAL_BATCHES,
        "resize_x2_cm": n_gen * n_models + ROUND_EVAL_BATCHES}


def check_round_run(rec, kernels: bool):
    """Labels, history and launch counts of a two-round run (none on the
    plain versions)."""
    for r, (cur, h) in enumerate(zip(rec["rounds"], rec["history"])):
        lab = cur["labels"]
        if lab.shape != (ROUND_TARGET, *HW) or not set(
                np.unique(lab).tolist()) <= {0, 1, 2, 255}:
            raise AssertionError(f"round {r} labels {lab.shape} "
                                 f"{np.unique(lab)[:8]}")
        if h["n_sources"] != 3 + r or not 0.0 <= h["miou"] <= 1.0 or not \
                0.0 < h["frac_kept"] <= 1.0:
            raise AssertionError(f"round {r} history {h}")
        want = (round_expected(h["n_sources"]) if kernels else
                {k: 0 for k in ALL_COUNTERS})
        if cur["launches"] != want:
            raise AssertionError(f"round {r} launches {cur['launches']}, "
                                 f"expected {want}")


def _agreement(a, b, r):
    return float((a["rounds"][r]["labels"] == b["rounds"][r]["labels"]
                  ).mean())


def _kc_gap(a, b, r):
    return float(np.abs(np.subtract(a["history"][r]["kc"],
                                    b["history"][r]["kc"])).max())


def phase_round(smi: str, sources, profile_dir=None):
    """Two full-width self-training rounds (phase 4's sources, an f32
    3-class target model) on the kernels, timed and counted, and their gate
    against the same rounds on the plain versions."""
    from mspl_tpu_torch.data.datasets import SyntheticSegmentation

    t_phase = time.perf_counter()
    target0 = init_random(ESPNetv2Segmentation(TRAIN_CLASSES, s=2.0),
                          torch.Generator().manual_seed(SEED + 3))
    size_wh = (HW[1], HW[0])
    target_set = CachedSet(SyntheticSegmentation(
        TRAIN_CLASSES, size_wh, ROUND_TARGET, seed=SEED + 4, unlabeled=True))
    val_set = CachedSet(SyntheticSegmentation(TRAIN_CLASSES, size_wh,
                                              ROUND_VAL, seed=SEED + 5))
    sets = (sources, target0, target_set, val_set)

    # the gate first (it also warms the plans and allocator): the rounds on
    # the kernels and on the plain versions, and the controls that change
    # only the fine-tune's branch stack, all with deterministic cuDNN
    det = run_rounds(*sets, deterministic=True)
    ref = run_rounds(*sets, plain=True, deterministic=True)
    controls = train_controls()
    ctrl = {name: run_rounds(*sets, plain=True, deterministic=True,
                             branch=_train_only(fn))
            for name, fn, _ in controls}
    timed = run_rounds(*sets)
    for rec in (det, timed):
        check_round_run(rec, kernels=True)
    for rec in (ref, *ctrl.values()):
        check_round_run(rec, kernels=False)

    for r, cur in enumerate(timed["rounds"]):
        h = timed["history"][r]
        train_ms = (cur["train"] - cur["eval"]) / ROUND_STEPS
        print(f"phase 7 round {r}: p {h['p']:.2f}, kc "
              f"{[round(k, 4) for k in h['kc']]}, kept {h['frac_kept']:.4f}, "
              f"{h['n_sources']} models ({cur['n_models']} in the fused pass),"
              f" val mIoU {h['miou']:.4f} | generation {cur['generate']:.2f} "
              f"ms ({ROUND_TARGET / cur['generate'] * 1e3:.2f} img/s), "
              f"sweep_kc + apply_kc_device {cur['kc']:.2f} ms, train "
              f"{train_ms:.2f} ms a step ({ROUND_BATCH / train_ms * 1e3:.2f} "
              f"img/s, {ROUND_STEPS} steps), eval {cur['eval']:.2f} ms "
              f"({ROUND_VAL} images), round {cur['secs']:.3f} s | launches "
              f"fused_pseudo_cm {cur['launches']['fused_pseudo_cm']}, "
              f"pyr_branches {cur['launches']['pyr_branches']}, "
              f"pyr_pool_fused_eval "
              f"{cur['launches']['pyr_pool_fused_eval']}, resize_x2_cm "
              f"{cur['launches']['resize_x2_cm']} on {smi}", flush=True)
    print(f"phase 7 two rounds: {timed['secs']:.3f} s of self_training "
          f"(host clock; each round's times between synchronizes) | "
          f"launches {json.dumps(timed['launches'])}", flush=True)

    gaps = {"kernels": det, **ctrl, "timed (default cuDNN)": timed}
    agree = {k: [_agreement(v, ref, r) for r in range(2)]
             for k, v in gaps.items()}
    kc_gap = {k: [_kc_gap(v, ref, r) for r in range(2)]
              for k, v in gaps.items()}
    before = {k: v.cuda() for k, v in target0.named_parameters()}
    tuned = lambda v, r: v["rounds"][r]["params"]  # noqa: E731
    p_gap = {k: [update_gap(tuned(v, r), tuned(ref, r), before)
                 for r in range(2)] for k, v in gaps.items()}
    p_elem = {k: [max(g.item() for g in param_gaps(
        tuned(v, r), tuned(ref, r), before).values()) for r in range(2)]
        for k, v in gaps.items()}
    print("phase 7 gate: thresholded labels agreeing with the same rounds "
          "on the plain versions (rounds 0, 1) and kc's largest gap: "
          + "; ".join(f"{k} {a[0]:.6f}, {a[1]:.6f} (kc {kc_gap[k][0]:.4g}, "
                      f"{kc_gap[k][1]:.4g})" for k, a in agree.items())
          + f" | limits {ROUND_AGREE}, kc round 0 within {KC_BIN:.6g}",
          flush=True)
    print("phase 7 gate: the target model's parameters after round 0's "
          "and round 1's fine-tune against the plain run's, |a - b| / "
          "|b - start| over all of them (and phase 6's per-tensor gap, not "
          "gated): " + "; ".join(
              f"{k} {g[0]:.3g}, {g[1]:.3g} ({p_elem[k][0]:.3g}, "
              f"{p_elem[k][1]:.3g})" for k, g in p_gap.items())
          + f" | limit {ROUND_PARAM_TOL}", flush=True)
    beyond = {name for name, _, seen in controls if seen}
    faults = [f"{k} round {r} agreement {a[r]:.6f} < {ROUND_AGREE[r]}"
              for k, a in agree.items() if k not in beyond
              for r in range(2) if a[r] < ROUND_AGREE[r]]
    faults += [f"the {k} fine-tune stays within round 1's limit "
               f"({agree[k][1]:.6f})" for k in LABELS_SEE
               if agree[k][1] >= ROUND_AGREE[1]]
    faults += [f"{k} parameter gap {g[0]:.3g} {'<=' if k in beyond else '>'}"
               f" {ROUND_PARAM_TOL}" for k, g in p_gap.items()
               if (g[0] > ROUND_PARAM_TOL) != (k in beyond)]
    faults += [f"{k} round 0 kc gap {g[0]:.4g}" for k, g in kc_gap.items()
               if g[0] > KC_BIN]
    if faults:
        raise AssertionError("phase 7 gate: " + "; ".join(faults))
    if profile_dir:
        profile_sweep(lambda n: run_rounds(*sets), ROUND_TARGET,
                      os.path.join(profile_dir, "round"),
                      "phase 7 two rounds")
    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return timed["launches"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=8,
                    help="timed batches of 128 of the main path and of each "
                         "phase-5 route (default 8)")
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one main-path sweep, one sweep of "
                         "the fuse_stages route and three train steps, "
                         "into DIR")
    args = ap.parse_args()
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    launches, _, gen, pool, lab_default = phase_main_path(
        args.batches, smi, args.profile)
    launches.update(phase_routes(args.batches, smi, gen, pool, lab_default,
                                 args.profile))
    sources = gen.sources
    del gen, pool
    train_launches = phase_train(smi, args.profile)
    round_launches = phase_round(smi, sources, args.profile)
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["round_launches"] = round_launches[r["name"]]
        if r["name"] == "pyr_branches":
            r["train_launches"] = train_launches
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
