"""Pseudo-label sweeps over an ensemble, timed for a window of seconds.

Set-up builds the port's kernels, makes a pool of seeded uint8 images in
host memory, makes each model's weights on the device from the seed with
its BatchNorm statistics calibrated on the pool (`member_states`), wraps
the models as the port's sources (the configuration's bf16 sources, and
with `target` in the traffic the cell's own model as an f32 member in its
own label space, as a self-training round from round 1 builds it), and
runs one sweep to warm every shape.  The traffic's `fusion` names the
module `reference/fusion_<fusion>.py` that gives the generator's fusion
keywords and the reference function that checks them.  The window then
runs whole sweeps, `PseudoLabelGenerator.__call__(loader,
return_device=True)` over the port's `DataLoader` and the traffic's CBST
calls, until its seconds have passed; a sweep that starts in the window
ends in it.

Batch completions are marked without a synchronize: the generator takes
batch k + 2 from the loader right after it has issued batch k's work, so a
CUDA event recorded as the loader hands over batch k + 2 follows batch k on
the stream; the last batch's mark is recorded after the sweep's CBST
calls.  The interval between consecutive marks is a batch's time to
completion, idle time included.

After the window the program is freed and the plain reference recomputes
every image of the last sweep, each sweep's sample of images drawn from
the seed, and each sweep's histograms and kc, in blocks.
"""

from __future__ import annotations

import importlib
import json
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from h100_bench import common, program
from h100_bench.reference import layers as ref_layers
from h100_bench.reference import pipeline as ref
from h100_bench.weights import calibrated, make_state, shapes_of

SAMPLE = 8  # images of each sweep kept for the comparison
CALIBRATION = 16  # pool images whose statistics the BatchNorms take


@dataclass
class Member:
    """One model of the ensemble."""
    name: str
    model: Dict          # the configuration's `model` entry
    route: Dict          # the configuration's `route` (the port's kernels)
    classes: int
    dtype: torch.dtype
    dataset: str         # its label space (the conversion table's source)
    target: bool         # the cell's own model, in the greenhouse space
    seed_path: int


def members(cell: common.Cell) -> List[Member]:
    tr = cell.traffic
    src_cfg = cell.config_named(tr["sources_from"])
    out = [Member(s["name"], src_cfg["model"], src_cfg.get("route", {}),
                  s["classes"], common.DTYPES[s["dtype"]], s["dataset"],
                  False, i)
           for i, s in enumerate(src_cfg["sources"])]
    if tr.get("target"):
        t = cell.config["target"]
        out.append(Member("target", cell.config["model"],
                          cell.config.get("route", {}), t["classes"],
                          common.DTYPES[t["dtype"]], "greenhouse", True,
                          len(out)))
    return out


def fusion(tr: Dict):
    """The traffic's fusion: `PROGRAM`, the keywords of the program's
    generator, and `fuse(logits, tables, kc)`, the reference's."""
    return importlib.import_module(
        f"h100_bench.reference.fusion_{tr['fusion']}")


def pool_input(ms: List[Member], pool: np.ndarray, lo: int, hi: int,
               device) -> torch.Tensor:
    """Images [lo, hi) of the pool as every model of the ensemble takes
    them: normalized and cast as the generator casts them."""
    imgs = torch.from_numpy(pool[np.arange(lo, hi) % len(pool)]).to(device)
    x = ref.normalize(imgs)
    cast = input_dtype(ms)
    return x if cast is None else x.to(cast)


def member_states(ms: List[Member], seed: int, pool: np.ndarray,
                  device) -> List[Dict[str, torch.Tensor]]:
    """Each member's weights, in host memory, the same for the program and
    the reference: drawn from the seed on the device, with every
    BatchNorm's running statistics taken from the pool's first images
    (`weights.calibrated`), so that the logits are of a trained model's
    size and the confidences spread."""
    x = pool_input(ms, pool, 0, min(CALIBRATION, len(pool)), device)
    out = []
    for m in ms:
        with torch.device(device):
            model = ref.build_model(m.model, m.classes, m.dtype)
        model.load_state_dict(make_state(
            m.model["name"], shapes_of(model),
            common.sub_seed(seed, 1, m.seed_path), device))
        out.append({k: v.cpu() for k, v in calibrated(model, x).items()})
        del model
    return out


def input_dtype(ms: List[Member]):
    """The dtype the generator casts the normalized batch to: the sources'
    one compute dtype (the target member stays out of the vote)."""
    votes = {m.dtype for m in ms if not m.target}
    return votes.pop() if len(votes) == 1 else None


class PoolImages:
    """`n` unlabeled images served by `load_batch` from the pool, with
    all-ignore uint8 labels as the port's unlabeled target sets give."""

    def __init__(self, n: int, pool: np.ndarray):
        self.n, self.pool = n, pool
        self.labels = np.full((1, *pool.shape[1:3]), ref.IGNORE, np.uint8)

    def __len__(self):
        return self.n

    def load_batch(self, idx):
        idx = np.asarray(idx)
        return (self.pool[idx % len(self.pool)],
                np.broadcast_to(self.labels, (len(idx),
                                              *self.labels.shape[1:])))


class HandOver:
    """The port's loader, with a mark recorded each time the program takes
    a batch from it (and when it finds the loader empty)."""

    def __init__(self, loader, clock: common.Clock, marks: list):
        self.loader, self.clock, self.marks = loader, clock, marks

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            self.marks.append(self.clock.mark())
            try:
                batch = next(it)
            except StopIteration:
                return
            yield batch


def build_program(cell, ms, states, device):
    from mspl_tpu_torch.pseudo import generate

    tr = cell.traffic
    fu = fusion(tr)
    sources = []
    for m, state in zip(ms, states):
        model = program.model(m.model, m.classes, m.dtype, device, m.route)
        model.load_state_dict(state)
        extra = {}
        if m.target:
            extra = {"conversion": ref.conversion("greenhouse", m.classes),
                     "num_target": m.classes, "compute_dtype": None}
        sources.append(generate.make_source(
            m.name, model, None, m.dataset, channel_major=True,
            device=device, **extra))
    kc = tr.get("kc_in_pass")
    gen = generate.PseudoLabelGenerator(
        sources, **fu.PROGRAM, device=device,
        kc=None if kc is None else np.full(tr["num_target"], kc, np.float32))
    return gen


def cbst(tr, labels, confs):
    """The traffic's CBST calls on a sweep's outputs: (kc, the labels
    after the re-threshold or None, the class-confidence histograms or
    None)."""
    from mspl_tpu_torch.pseudo import cbst as pc

    t = tr["num_target"]
    if tr.get("apply_kc"):
        kc = pc.sweep_kc(labels, confs, t, tr["p"])
        return kc, pc.apply_kc_device(labels, confs, kc), None
    hist = pc.class_confidence_histograms(labels, confs, t)
    return pc.kc_from_histograms(hist, tr["p"]), None, hist


def run(cell: common.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> common.Result:
    from mspl_tpu_torch.data.loader import DataLoader

    from h100_bench import layers_read
    from h100_bench.trace import Profiled, breakdown

    tr = cell.traffic
    clock = common.Clock(device)
    ms = members(cell)
    hw = tuple(cell.config["image_hw"])
    pool = common.uint8_images(common.sub_seed(seed, 2), tr["pool_images"],
                               hw, device)
    states = member_states(ms, seed, pool, device)
    gen = build_program(cell, ms, states, device)
    data = PoolImages(tr["sweep_images"], pool)
    n_batches = -(-tr["sweep_images"] // tr["batch"])
    counters = program.launch_counters(cell.launches)

    def sweep(marks):
        loader = DataLoader(data, batch_size=tr["batch"],
                            num_workers=tr["loader_workers"])
        labels, confs, _ = gen(HandOver(loader, clock, marks),
                               return_device=True)
        kc, thr, hist = cbst(tr, labels, confs)
        marks.append(clock.mark())
        return labels, confs, (kc, hist), thr

    sweep([])  # every shape of the window, once
    rng = np.random.default_rng(common.sub_seed(seed, 3))
    for fn in counters.values():
        fn.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    clock.sync()
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    start = clock.mark()
    done, cbsts, samples, view = [], [], [], None
    last = None
    while True:
        marks = []
        prof = None
        if trace and len(cbsts) == tr["trace_sweep"]:
            prof = Profiled(device)
            prof.start()
        labels, confs, kc_hist, thr = sweep(marks)
        if prof is not None:
            view = prof.stop()
        # batch k's mark is the hand-over of batch k + 2; the last's is
        # the sweep's end
        done.append(marks[2:])
        cbsts.append(kc_hist)
        pick = np.sort(rng.choice(tr["sweep_images"], SAMPLE, replace=False))
        idx = torch.as_tensor(pick, device=labels.device)
        samples.append((pick, labels[idx].clone(), confs[idx].clone()))
        last = (labels, confs, thr)
        if time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    launches = {k: fn.launches for k, fn in counters.items()}
    sweeps = len(cbsts)
    batch_ms = common.intervals_ms(clock, [start] + [m for d in done
                                                     for m in d])
    images = sweeps * tr["sweep_images"]
    metrics = {}
    if not trace:
        metrics = {
            "pseudo_img_per_s": {"value": images / wall, "unit": "img/s"},
            "pseudo_batch_ms_p95": {"value": common.p95(batch_ms),
                                    "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    print(f"sweep window: {sweeps} sweeps, {images} images, {wall:.3f} s, "
          f"{len(batch_ms)} batch intervals (median "
          f"{float(np.median(batch_ms)):.3f} ms, p95 "
          f"{common.p95(batch_ms):.3f} ms, longest "
          f"{common.longest(batch_ms)}), set-up {setup_s:.3f} s, "
          f"launches {launches}", flush=True)

    reading = None
    if view is not None:
        reading = layers_read.Reading(
            view=view, units=n_batches, cell=cell, peak_bytes=peak,
            members=ms, hw=hw,
            batch=tr["batch"], train=False)
    # the program's state goes before the reference runs
    del gen
    labels, confs, thr = last
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = compare(cell, ms, states, pool, labels, confs, thr, cbsts,
                     samples, device)
    del labels, confs, thr, samples, last
    print(f"readings: {json.dumps(values)}", flush=True)
    expect = cell.launches
    values["launch_excess"] = max(
        [abs(launches[k] - per * n_batches * sweeps)
         for k, per in expect.items()] or [0])
    res = common.Result(
        attempted=images, metrics=metrics,
        checks=common.checks_from(values, cell.limits),
        memory_peak_bytes=int(peak))
    if reading is not None:
        res.metrics = layers_read.read_all(reading)
        res.busy_s, res.window_s = (view.busy_us() / 1e6,
                                    view.window_us / 1e6)
        res.breakdown = breakdown(view)
    return res


# --- the comparison ---

def numerics(ms: List[Member], control: bool = False):
    """Each member's convolution numerics: its own dtype's, or for the
    control the precision below it (fp8 under bf16, TF32 under f32)."""
    if not control:
        return [ref_layers.PLAIN] * len(ms)
    return [ref_layers.FP8Numerics() if m.dtype == torch.bfloat16
            else ref_layers.TF32Numerics() for m in ms]


def reference_models(ms: List[Member], states, device, nums):
    models = []
    for m, state, num in zip(ms, states, nums):
        with torch.device(device):
            model = ref.build_model(m.model, m.classes, m.dtype, num)
        model.load_state_dict(state)
        models.append(model.eval())
    return models


@torch.no_grad()
def reference_outputs(ms, models, pool, lo, hi, device, tr):
    """(label, conf) of images [lo, hi) of the sweep by the reference."""
    x = pool_input(ms, pool, lo, hi, device)
    logits = [mod(x) for mod in models]
    tables = [ref.conversion(m.dataset, tr["num_target"]) for m in ms]
    kc = tr.get("kc_in_pass")
    label, conf, _ = fusion(tr).fuse(
        logits, tables, None if kc is None else [kc] * tr["num_target"])
    return label, conf


def reference_sweep(ms, states, pool, tr, device, nums, each_block):
    """The reference's sweep in blocks of the program's batch (cuDNN picks
    its algorithms by shape, so other blocks would round otherwise):
    calls `each_block(lo, hi, label, conf)` for images [lo, hi) and
    returns the sweep's (kc, class-confidence histograms)."""
    models = reference_models(ms, states, device, nums)
    hist = None
    for lo, hi in common.sizes(tr["sweep_images"], tr["batch"]):
        label, conf = reference_outputs(ms, models, pool, lo, hi, device, tr)
        h = ref.histograms(label, conf, tr["num_target"])
        hist = h if hist is None else hist + h
        each_block(lo, hi, label, conf)
    return ref.kc_from_histograms(hist, tr["p"]), hist


class Tally:
    """Running sums of the label and confidence gaps, and per image."""

    def __init__(self):
        self.px = self.mismatch = self.thr_mismatch = 0
        self.abs_conf = 0.0
        self.per_image: List[float] = []

    def add(self, lab_p, lab_r, conf_p, conf_r):
        lab_p, lab_r = lab_p.long(), lab_r.long()
        diff = (lab_p != lab_r).reshape(lab_p.shape[0], -1).double()
        self.per_image += diff.mean(1).tolist()
        self.mismatch += int(diff.sum())
        self.px += lab_p.numel()
        self.abs_conf += float((conf_p.float() - conf_r.float()).abs().sum(
            dtype=torch.float64))


def compare(cell, ms, states, pool, labels, confs, thr, cbsts, samples,
            device):
    """The comparison's numbers: label and re-threshold mismatch shares,
    the worst image's, the mean confidence gap; where the sweep returns
    its histograms (`cbsts`: each sweep's kc and histograms or None), the
    worst sweep's histogram gap (L1 over the pixel count) and, from the
    program's own histograms, kc's gap in bins."""
    tr = cell.traffic
    tally = Tally()
    thr_bad = thr_px = 0
    ref_blocks = []

    def each_block(lo, hi, label, conf):
        tally.add(labels[lo:hi], label, confs[lo:hi], conf)
        for pick, lab_s, conf_s in samples[:-1]:
            sel = np.nonzero((pick >= lo) & (pick < hi))[0]
            if sel.size:
                rows = torch.as_tensor(pick[sel] - lo, device=label.device)
                tally.add(lab_s[sel], label[rows], conf_s[sel], conf[rows])
        if thr is not None:
            ref_blocks.append((lo, hi, label, conf))

    kc_ref, hist_ref = reference_sweep(ms, states, pool, tr, device,
                                       numerics(ms), each_block)
    if thr is not None:
        for lo, hi, label, conf in ref_blocks:
            want = ref.apply_kc(label, conf, kc_ref)
            thr_bad += int((thr[lo:hi].long() != want.long()).sum())
            thr_px += want.numel()
    values = {"label_mismatch": tally.mismatch / tally.px,
              "image_mismatch_max": max(tally.per_image),
              "conf_mae": tally.abs_conf / tally.px}
    if thr is not None:
        values["thr_mismatch"] = thr_bad / thr_px
    hists = [(np.asarray(k, np.float64), h) for k, h in cbsts
             if h is not None]
    if hists:
        total = float(hist_ref.sum())
        values["hist_gap"] = max(
            float((h.double().to(hist_ref.device) - hist_ref).abs().sum())
            for _, h in hists) / total
        values["kc_stage_bins"] = max(
            float(np.abs(k - ref.kc_from_histograms(h, tr["p"])).max())
            for k, h in hists) * 1024
    return values
