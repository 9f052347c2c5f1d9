"""Rounding gaps behind the parity bounds of the port's train-step tests,
on the CPU: each framework's fp32 step against the port's same step in
f64 (`tests/test_torch_train.py::_f64_twin`), at several torch thread
counts.  Run from the repo root:

    python -m tests.torch_rounding_gaps [--threads 1 2 4 8] [--full]

Prints, per thread count, for
- the small DeepLab's SGD step (`test_deeplab_sgd_step_matches_jax`, batch
  2 and 1): the largest running-statistic gap of the port and of JAX
  (means absolute, variances relative);
- the resumed third AdamW step (`test_jax_resumes_a_port_train_state`):
  the elements beyond 1e-6 + 1e-5 relative and the largest gap;
- the classifier's SGD step (`tests/test_torch_cls.py`, batch 4 at 64x64)
  and the ghost-batch steps (`tests/test_torch_bn_groups.py`): the loss
  and the updates' gaps in `_update_gaps`' terms.
With `--full`, also the CPU fp32 step against its f64 step at full width
(the ESPNetv2-s2.0 classifier at batch 8, 224x224; the 3-class ESPNetv2
at `bn_groups=4`, batch 8, 256x480), in `chip_smoke.py`'s `_step_gaps`
terms: the basis of its `CPU_TRAIN_TOL`.  Takes about a minute, and one
more with `--full`."""

import argparse
import copy
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tests.test_torch_bn_groups as tb
import tests.test_torch_checkpoint as tc
import tests.test_torch_cls as tcls
import tests.test_torch_train as tt
from mspl_tpu.models import DeepLabV3 as FlaxDeepLab
from mspl_tpu.utils import checkpoint as jax_ckpt
from mspl_tpu_torch.engine.losses import compute_class_weights
from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import (create_train_state, make_train_step,
                                         train_state_tree)
from mspl_tpu_torch.engine.train_cls import make_cls_train_step
from mspl_tpu_torch.models import DeepLabV3
from mspl_tpu_torch.utils import checkpoint as port_ckpt
from mspl_tpu_torch.utils.flax_bridge import load_flax_variables


def _stat_gaps(a, ref):
    """Largest running-mean gap (absolute) and running-variance gap
    (relative) of model `a` against model `ref`."""
    ra = dict(a.named_buffers())
    mean = var = 0.0
    for k, t in ref.named_buffers():
        d = (ra[k].double() - t.double()).abs()
        if k.endswith("running_mean"):
            mean = max(mean, d.max().item())
        elif k.endswith("running_var"):
            var = max(var, (d / t.double().abs()).max().item())
    return mean, var


def _f32(model):
    out = copy.deepcopy(model).float()
    for mod in out.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float32
    return out


def deeplab(threads):
    kw = dict(stage_blocks=(1, 1, 1, 1), aspp_features=16)
    model = FlaxDeepLab(num_classes=tt.CLASSES, **kw)
    variables = tt.flax_variables(model, tt.HW, seed=14)
    for batch in (2, 1):
        batches = [{k: v[:batch] for k, v in b.items()}
                   for b in tt._batches(1)]
        labels = batches[0]["label"]
        cw = compute_class_weights(np.bincount(labels[labels != 255],
                                               minlength=tt.CLASSES))
        (_, want_tree), = tt._trajectory(model, variables, batches, cw,
                                         tt.SGD_SCHEDULE, "sgd", 1)
        for n in threads:
            torch.set_num_threads(n)
            port = DeepLabV3(tt.CLASSES, **kw)
            load_flax_variables(port, variables)
            state = create_train_state(port, "sgd", build_schedule(
                "hybrid", 0.005, 6, max_lr=0.01, cycle_epochs=3),
                device="cpu")
            wide, wide_step = tt._f64_twin(state, "sgd", cw)
            make_train_step(port, class_weights=cw, augment=False,
                            device="cpu")(state, batches[0])
            wide_step(wide, batches[0])
            ref = tt._flax_layout(want_tree, port)
            print(f"deeplab batch {batch}, {n} threads: statistics (mean, "
                  f"var) port-f64 {_stat_gaps(port, wide.model)}, JAX-f64 "
                  f"{_stat_gaps(ref, wide.model)}", flush=True)


def adam_resume(threads):
    tmp = tempfile.mkdtemp()

    class Factory:
        def mktemp(self, name):
            return pathlib.Path(tempfile.mkdtemp(dir=tmp))

    runs = tc.jax_runs.__wrapped__(Factory())
    run = runs["adam"]
    for n in threads:
        torch.set_num_threads(n)
        state, step = tc._port_state(runs["variables"], "adam")
        for i in range(2):
            state, _ = step(state, runs["batches"][i])
        d = tempfile.mkdtemp(dir=tmp)
        port_ckpt.save_checkpoint(d, train_state_tree(state))
        jstate, _ = jax_ckpt.load_checkpoint(d, run["fresh"])
        jstate, _ = run["step"](jstate, jax.tree_util.tree_map(
            jnp.asarray, runs["batches"][2]), jax.random.PRNGKey(2))
        wide, wide_step = tt._f64_twin(state, "adam")
        wide_step(wide, runs["batches"][2])
        step(state, runs["batches"][2])
        ref = tt._flax_layout(tt._numpy_tree(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}),
            state.model)
        line = []
        for who, m in (("port", state.model), ("JAX", ref)):
            pm = dict(m.named_parameters())
            off = total = 0
            top = 0.0
            for k, w in wide.model.named_parameters():
                w = w.detach().double()
                gap = (pm[k].detach().double() - w).abs()
                off += int((gap > 1e-6 + 1e-5 * w.abs()).sum())
                total += gap.numel()
                top = max(top, gap.max().item())
            line.append(f"{who}-f64 {off} of {total} off, largest {top:.3g}")
        print(f"AdamW resume, {n} threads: " + "; ".join(line), flush=True)


def _update_worst(a, ref, start):
    g = tt._update_gaps(a, ref, start)
    return (max(v[0] for v in g.values()), max(v[1] for v in g.values()))


def _cls_losses(case, hw):
    """The classifier's train-mode loss on a batch of 4 at `hw` from the
    step case's tree: port fp32, port f64, JAX fp32."""
    import optax

    from mspl_tpu.data.transforms import normalize as jax_normalize
    from mspl_tpu_torch.data.transforms import normalize

    img = tcls._images(4, 34, hw)
    lab = np.random.default_rng(35).integers(0, tcls.CLASSES, 4)
    flax_model = tcls.FlaxEESPNet(s=0.5, num_classes=tcls.CLASSES,
                                  drop_rate=0.0)
    v = case["variables"]

    def jax_loss(params):
        out, _ = flax_model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jax_normalize(jnp.asarray(img)), train=True,
            mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(lab)).mean()

    out = []
    for dtype in (torch.float32, torch.float64):
        port = tcls._port(v, 0.5, drop_rate=0.0).train().to(dtype)
        port.compute_dtype = dtype
        with torch.no_grad():
            out.append(torch.nn.functional.cross_entropy(
                port(normalize(torch.from_numpy(img))),
                torch.from_numpy(lab)).item())
    return out + [float(jax.jit(jax_loss)(v["params"]))]


def classifier_and_ghost(threads):
    case = tcls.step_case.__wrapped__()
    want_loss, _, want_tree = case[("sgd", 4)]
    for hw in ((32, 32), (64, 64)):
        p32, p64, j32 = _cls_losses(case, hw)
        print(f"classifier train-mode loss, batch 4 at {hw[0]}x{hw[1]}: "
              f"port-f64 {abs(p32 - p64) / p64:.3g}, JAX-f64 "
              f"{abs(j32 - p64) / p64:.3g} (relative)", flush=True)
    for n in threads:
        torch.set_num_threads(n)
        port = tcls._port(case["variables"], 0.5, drop_rate=0.0)
        start = {k: t.detach().clone() for k, t in port.named_parameters()}
        sched = build_schedule("hybrid", 0.005, 6, max_lr=0.01,
                               cycle_epochs=3)
        state = create_train_state(port, "sgd", sched, device="cpu")
        wide = copy.deepcopy(port).double()
        wide.compute_dtype = torch.float64
        wstate = create_train_state(wide, "sgd", sched, device="cpu")
        _, m = make_cls_train_step(port, device="cpu")(
            state, case["batches"][4])
        _, wm = make_cls_train_step(wide, device="cpu")(
            wstate, case["batches"][4])
        w32 = _f32(wide)
        ref = tt._flax_layout(want_tree, port)
        loss = wm["loss"].item()
        print(f"classifier SGD step (batch 4, 64x64), {n} threads: loss "
              f"port-f64 {abs(m['loss'].item() - loss) / loss:.3g}, JAX-f64 "
              f"{abs(want_loss - loss) / loss:.3g}; updates (norm, element) "
              f"port-f64 {_update_worst(port, w32, start)}, JAX-f64 "
              f"{_update_worst(ref, w32, start)}", flush=True)
    for name in ("espnetv2", "deeplabv3"):
        n_rows = 4 if name == "espnetv2" else 2
        if name == "espnetv2":
            flax_model = tb.FlaxESPNetv2(num_classes=tt.CLASSES,
                                         channel_major_logits=True,
                                         **tt.MODEL_KW)
        else:
            flax_model = FlaxDeepLab(num_classes=tt.CLASSES, **tb.DL_KW)
        variables = tt.flax_variables(flax_model, tt.HW, seed=41)
        b = tt._batches(2)
        batch = {k: np.concatenate([b[0][k], b[1][k]])[:n_rows]
                 for k in b[0]}
        labels = batch["label"]
        cw = compute_class_weights(np.bincount(labels[labels != 255],
                                               minlength=tt.CLASSES))
        want_loss, _ = tb._jax_ghost_step(flax_model, variables, batch, cw,
                                          2)
        for n in threads:
            torch.set_num_threads(n)
            port = (tb.ESPNetv2Segmentation(tt.CLASSES, **tt.MODEL_KW)
                    if name == "espnetv2" else DeepLabV3(tt.CLASSES,
                                                         **tb.DL_KW))
            load_flax_variables(port, variables)
            state = create_train_state(port, "sgd", build_schedule(
                "hybrid", 0.005, 6, max_lr=0.01, cycle_epochs=3),
                device="cpu")
            wide, wide_step = tt._f64_twin(state, "sgd", cw, bn_groups=2)
            _, m = make_train_step(port, class_weights=cw, augment=False,
                                   bn_groups=2, device="cpu")(state, batch)
            _, wm = wide_step(wide, batch)
            loss = wm["loss"].item()
            print(f"{name} ghost-batch step (groups of {n_rows // 2}), {n} "
                  f"threads: loss port-f64 "
                  f"{abs(m['loss'].item() - loss) / loss:.3g}, JAX-f64 "
                  f"{abs(want_loss - loss) / loss:.3g}", flush=True)


def full_width():
    """The CPU's fp32 step against its f64 step at full width, on phase
    10's weights, batches and schedules, in `chip_smoke.py`'s `_step_gaps`
    terms."""
    import chip_smoke as cs
    from mspl_tpu_torch.models.espnetv2 import (ESPNetv2Segmentation,
                                                init_random)

    cls = cs.cls_model()
    cls.drop_rate = 0.0
    rng = np.random.default_rng(cs.SEED + 22)
    images = rng.integers(0, 256, (cs.CLS_BATCH, *cs.CLS_HW, 3),
                          dtype=np.uint8)
    labels = rng.integers(0, cs.CLS_CLASSES, cs.CLS_BATCH)
    n = cs.CLS_CPU_BATCH
    cls_batch = {"image": torch.from_numpy(images[:n]),
                 "label": torch.from_numpy(labels[:n])}
    seg = init_random(ESPNetv2Segmentation(cs.TRAIN_CLASSES, s=2.0),
                      torch.Generator().manual_seed(cs.SEED))
    rng = np.random.default_rng(cs.SEED + 1)
    images = rng.integers(0, 256, (cs.TRAIN_BATCH, *cs.HW, 3),
                          dtype=np.uint8)
    labels = rng.integers(0, cs.TRAIN_CLASSES,
                          (cs.TRAIN_BATCH, *cs.HW)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.1] = 255
    cw = compute_class_weights(np.bincount(labels[labels != 255],
                                           minlength=cs.TRAIN_CLASSES))
    seg_batch = {"image": torch.from_numpy(images),
                 "label": torch.from_numpy(labels)}
    for name, model0, batch, lr, make in (
            ("classifier, batch 8 at 224x224", cls, cls_batch, cs.CLS_LR,
             lambda m: make_cls_train_step(m, device="cpu")),
            (f"ESPNetv2 at bn_groups {cs.BN_GROUPS}, batch 8 at 256x480",
             seg, seg_batch, 0.009,
             lambda m: make_train_step(m, class_weights=cw, augment=False,
                                       bn_groups=cs.BN_GROUPS,
                                       device="cpu"))):
        states, losses = [], []
        for dtype in (torch.float32, torch.float64):
            m = copy.deepcopy(model0).to(dtype)
            for mod in m.modules():
                if hasattr(mod, "compute_dtype"):
                    mod.compute_dtype = dtype
            st = create_train_state(m, "sgd", build_schedule(
                "hybrid", lr, cs.TRAIN_STEPS), device="cpu")
            st, met = make(m)(st, batch)
            states.append(st)
            losses.append(met["loss"].item())
        wide = states[1]
        wide.model = _f32(wide.model)
        for p, w in zip(wide.model.parameters(),
                        states[1].optimizer.param_groups[0]["params"]):
            p.grad = w.grad.float()
        gaps, where = cs._step_gaps(states[0], wide, model0)
        gaps["loss"] = abs(losses[0] - losses[1]) / abs(losses[1])
        print(f"full width, {name}: CPU fp32 against f64 "
              + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
              + f" at {where}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    deeplab(args.threads)
    adam_resume(args.threads)
    classifier_and_ghost(args.threads)
    if args.full:
        torch.set_num_threads(4)
        full_width()


if __name__ == "__main__":
    main()
