#!/usr/bin/env python3
"""The route kernels ⑤ (`eesp_branches`, `use_pallas`), ⑦ (`down_front`)
and ⑧ (`fused_pseudo_pass_pm`, NHWC `use_pallas`) alone, on one CUDA card.

    python3 tools/torch_route_kernels.py [--tree DIR] [--repeats N]

Prints the card's name and power limit, then builds only `eesp_branches`
and `pseudo_pm` (the build seconds and the compiler's registers, spills
and stack of every kernel instance), runs `chip_smoke.py`'s phase-3
checks of ⑤ (the main path's calls and the odd shapes), ⑦ (its calls,
odd shapes and backward: `check_front`) and ⑧
(every fusion and confidence, f32, bf16 and the mixed ensemble, at the
main plane and the odd pixel count), and times with CUDA events (the
least of N runs of 5 repetitions), with the kernels' device time a call
beside (torch.profiler) and the host's time to issue a call: ⑤ on one
level3 call ([128, 64, 32, 60], dilations (1,2,3,4)), one level4 call
([128, 128, 16, 30], (1,1,2,3)) and the route's 30 calls of a batch with
their taps packed as the route hands them, beside the default route's
cuDNN stack on the same 30 calls; ⑦ on each level's call (the three
DownSamplers of `chip_smoke.FRONTS`) and the 9 calls of a batch, each
with its two kernels' device time, beside the default route's strided
front on them (`chip_smoke.cudnn_front`); ⑧ on the main path's bf16
batch of 128 and on the round's mixed ensemble at batch 8 (3 bf16
sources and an f32 3-class model); each beside its bound from
`chip_smoke.eesp_work`, `front_work` and `pm_work`.  Last it prints one
JSON object.

`--tree DIR` imports `chip_smoke` and `mspl_tpu_torch` from another
checkout (for example `git archive` of another commit that has this
tool, unpacked into a git-ignored directory; the tool runs that tree's
`chip_smoke` calls and checks), whose build goes into that checkout's
`_build/`:
run the tool from both trees in turns in one call to compare two versions
of the kernels (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("eesp_branches", "pseudo_pm")


def ptxas_lines(log: Path):
    """Each kernel instance's registers, spills and stack, from the
    compiler's `-Xptxas -v` log."""
    out, name, frame = [], None, ""
    for ln in log.read_text(errors="replace").splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif name and "bytes stack frame" in ln:
            frame = ln.split("ptxas info    :")[-1].strip()
        elif name and "Used" in ln:
            used = ln.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name}: {used}; {frame}")
            name = None
    return out


def device_by_kernel(fn, reps: int = 5) -> dict:
    """Device time of one call of `fn` by kernel name (torch.profiler) over
    `reps` calls, a call's share, in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def device_ms(fn, reps: int = 5) -> float:
    """Device time of one call of `fn`: its kernels' time (torch.profiler)
    over `reps` calls, a call's share."""
    return sum(device_by_kernel(fn, reps).values())


def host_us(fn, calls: int, reps: int = 20) -> float:
    """The host's time to issue one of the `calls` wrapper calls of `fn`,
    without waiting for the card, in microseconds."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / calls * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="checkout to import chip_smoke and mspl_tpu_torch "
                         "from (default: this one)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs a case, the least kept (default 3)")
    ap.add_argument("--reps", type=int, default=5,
                    help="calls a timed run, CUDA events around them "
                         "(default 5)")
    args = ap.parse_args()
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from mspl_tpu_torch.data.label_space import label_conversion_matrix
    from mspl_tpu_torch.ops import _cuda, eesp_branches, pseudo

    for mod in (cs, _cuda):
        if tree not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} came from {mod.__file__}, "
                             f"not from {tree}")
    smi = cs.phase_device()
    print(f"tree {tree}", flush=True)
    secs = _cuda.build_all(SOURCES)
    instances = {}
    for name in SOURCES:
        log = _cuda.BUILD / f"{name}.log"
        lines = ptxas_lines(log) if log.exists() else ["no compiler log"]
        instances[name] = lines
        print(f"build {name}: {len(lines)} kernel instances | "
              + " | ".join(lines), flush=True)
    print(f"build {' + '.join(SOURCES)}: {secs:.1f} s (in parallel)",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    err16 = {
        "eesp_branches": cs.check_elementwise(
            eesp_branches.eesp_branches, eesp_branches.eesp_branches_plain,
            cs.with_odd(cs.eesp_calls, cs.eesp_odd_calls), gen, 1e-5,
            "eesp_branches", rtol32=1e-5),
        "down_front": cs.check_front(gen)[0]}
    pm_errs = cs.check_pm(gen)
    err16["fused_pseudo_pass_pm"] = pm_errs[torch.bfloat16]
    print(f"checks passed (with the odd shapes; chip_smoke phase 3: fp32 within 1e-5 "
          "+ rtol 1e-5 for the stacks, confidences within 1e-5 and decided "
          "labels equal for the pass; bf16 within one bf16 rounding) | "
          "bf16 max |err| " + ", ".join(f"{k} {v:.3g}" for k, v in err16.items())
          + f" | mixed ensemble max |conf err| {pm_errs['mixed']:.3g}",
          flush=True)

    def least(fn):
        return min(cs.time_ms(fn, args.reps) for _ in range(args.repeats))

    times, bounds, dev, host = {}, {}, {}, {}
    calls = cs.eesp_calls(cs.BATCH, torch.bfloat16, gen)
    level3 = next(c for c in calls if c[0].shape[2] == 32)
    level4 = next(c for c in calls if c[0].shape[2] == 16)
    cases = [("eesp_branches level3", [level3]),
             ("eesp_branches level4", [level4]),
             (f"eesp_branches route, {len(calls)} calls", calls)]
    for name, sub in cases:
        run = lambda sub=sub: [  # noqa: E731
            eesp_branches.eesp_branches(*a) for a in sub]
        times[name] = least(run)
        dev[name] = device_ms(run)
        host[name] = host_us(run, len(sub))
        bounds[name] = cs.bound(*cs.eesp_work(sub))[0]
    dw = [(x, cs.dw_kernels(wts, d, x.dtype), d) for x, wts, d in calls]
    cudnn = least(lambda: [cs.cudnn_stack(*a) for a in dw])
    cudnn_dev = device_ms(lambda: [cs.cudnn_stack(*a) for a in dw])
    route = cases[-1][0]
    del dw, calls, level3, level4, cases, run

    calls = cs.front_calls(cs.BATCH, torch.bfloat16, gen)
    fronts = [(f"down_front level{i + 1} {tuple(calls[i][0].shape)}",
               [calls[i]]) for i in range(len(cs.FRONTS))]
    fronts.append((f"down_front, {len(calls)} calls", calls))
    front_split = {}
    for name, sub in fronts:
        run = lambda sub=sub: [  # noqa: E731
            eesp_branches.down_front(*a) for a in sub]
        times[name] = least(run)
        split = {}  # by kernel, its template instances summed
        for k, v in device_by_kernel(run).items():
            key = k.split("(")[0].split("<")[0].split()[-1]
            split[key] = split.get(key, 0.0) + v
        front_split[name] = split
        dev[name] = sum(split.values())
        host[name] = host_us(run, len(sub))
        bounds[name] = cs.bound(*cs.front_work(sub))[0]
    for name, split in front_split.items():
        print(f"{name}: device ms by kernel " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    dw = [(x, p, cs.dw_kernels(wts, d, x.dtype), d) for x, p, wts, d in calls]
    front_cudnn = least(lambda: [cs.cudnn_front(*a) for a in dw])
    front_cudnn_dev = device_ms(lambda: [cs.cudnn_front(*a) for a in dw])
    front_route = fronts[-1][0]
    del calls, fronts, run, dw

    convs = [label_conversion_matrix(n) for n, _ in cs.SOURCES]
    kc = torch.full((3,), cs.KC, device="cuda")
    (logits,), = cs.pm_calls(cs.BATCH, torch.bfloat16, gen)
    mixed, mixed_convs = cs.mixed_calls(cs.ROUND_BATCH, gen,
                                        channel_last=True)
    mixed_kc = torch.tensor(cs.MIXED_KC, device="cuda")
    pm_cases = (
        (f"fused_pseudo_pass_pm bf16 batch {cs.BATCH}", logits, convs, kc),
        (f"fused_pseudo_pass_pm mixed batch {cs.ROUND_BATCH}", mixed,
         mixed_convs, mixed_kc))

    for name, lg, cv, k in pm_cases:
        run = lambda lg=lg, cv=cv, k=k: (  # noqa: E731
            pseudo.fused_pseudo_pass_pm(lg, cv, kc=k))
        times[name] = least(run)
        dev[name] = device_ms(run)
        host[name] = host_us(run, 1)
        bounds[name] = cs.bound(*cs.pm_work([(lg,)]))[0]
    for name, ms in times.items():
        print(f"{name}: {ms:.4f} ms (CUDA events), device {dev[name]:.4f} "
              f"ms (profiler), host {host[name]:.1f} us a call, bound "
              f"{bounds[name]:.4f} ms (bytes) on {smi}", flush=True)
    print(f"default route's cuDNN branch stack on the same calls: "
          f"{cudnn:.4f} ms (CUDA events), device {cudnn_dev:.4f} ms "
          f"(profiler); the kernel {times[route]:.4f}, device "
          f"{dev[route]:.4f}", flush=True)
    print(f"default route's strided DownSampler front on the same calls: "
          f"{front_cudnn:.4f} ms (CUDA events), device {front_cudnn_dev:.4f} "
          f"ms (profiler); the kernels {times[front_route]:.4f}, device "
          f"{dev[front_route]:.4f}", flush=True)
    print(json.dumps({"card": smi, "tree": str(tree), "build_s": secs,
                      "instances": {k: len(v) for k, v in instances.items()},
                      "bf16_err": err16, "mixed_err": pm_errs["mixed"],
                      "ms": times, "device_ms": dev, "host_us": host,
                      "bound_ms": bounds,
                      "cudnn_stack_ms": cudnn,
                      "cudnn_stack_device_ms": cudnn_dev,
                      "front_by_kernel_ms": front_split,
                      "cudnn_front_ms": front_cudnn,
                      "cudnn_front_device_ms": front_cudnn_dev}),
          flush=True)


if __name__ == "__main__":
    main()
