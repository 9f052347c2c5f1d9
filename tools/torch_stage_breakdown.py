#!/usr/bin/env python3
"""The fused EESP stage kernel (⑥, `fuse_stages`) alone, on one CUDA card.

    python3 tools/torch_stage_breakdown.py [--tree DIR] [--repeats N]

Prints the card's name and power limit, then builds only `eesp_stage`
(the build seconds and the compiler's registers and spills of
`eesp_unit_kernel`), runs `chip_smoke.py`'s stage check (the main path's
stages of three sources plus the dense-expand chain at batch 8, fp32 and
bf16, at that script's tolerances) and reports the largest fp32 error over
the output's rms, and times the kernel with CUDA events (the least of N
runs of 5 repetitions) at bf16 batch 128: one source's level3 stage (3
units, [128, 256, 32, 60]), its level4 stage (7 units, [128, 512, 16,
30]) and the route's 30 launches (both stages of the three sources), each
beside its bound from `chip_smoke.stage_work`.  Last it counts the HMMA
(tensor-core) instructions of each `eesp_unit_kernel` instance in the
built library (`cuobjdump -sass`) and prints one JSON object.

`--skip 1,2,4,8` also times trial builds of the kernel that leave phases
out (the kernel's EESP_SKIP mask: 1 the proj's staging, 2 the proj's
products and epilogue, 4 the taps, 8 the expand's products and epilogue;
15 leaves the launch and the zeroing alone); their outputs are wrong and
not checked.  The time a phase takes is about the full kernel's less the
trial's without it.

`--tree DIR` imports `chip_smoke` and `mspl_tpu_torch` from another
checkout (for example `git archive` of an earlier commit, unpacked into a
git-ignored directory), whose build goes into that checkout's `_build/`:
run the tool from both trees in turns in one call to compare two kernels.
Without `--tree` a count of 0 HMMA instructions fails the run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def ptxas_lines(log: Path):
    """The compiler's lines of each eesp_unit_kernel instance."""
    out, keep = [], False
    for ln in log.read_text(errors="replace").splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            keep = "eesp_unit_kernel" in ln
            if keep and "Compiling" in ln:
                out.append(ln.split("'")[1] if "'" in ln else ln)
        elif keep and ("Used" in ln or "spill" in ln):
            out.append(ln.strip().replace("ptxas info    : ", ""))
    return out


def hmma_counts(lib: Path, nvcc: str):
    """HMMA instructions of each eesp_unit_kernel instance in `lib`."""
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
        elif name and "eesp_unit_kernel" in name and "HMMA" in ln:
            counts[name] = counts.get(name, 0) + 1
    return counts


def skip_builds(_cuda, masks):
    """Trial libraries of `eesp_stage.cu` with EESP_SKIP set, compiled in
    parallel into the build directory."""
    procs = []
    for mask in masks:
        out = _cuda.BUILD / f"libeesp_stage_skip{mask}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-DEESP_SKIP={mask}", "-o",
               str(out), str(_cuda.CSRC / "eesp_stage.cu")]
        procs.append((mask, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for mask, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc -DEESP_SKIP={mask}:\n{log.decode()}")
        lib = ctypes.CDLL(str(out))
        lib.mspl_error_string.argtypes = [ctypes.c_int]
        lib.mspl_error_string.restype = ctypes.c_char_p
        libs[mask] = lib
    return libs


def time_cases(cs, eesp_stage, cases, repeats):
    """ms of each case: the least of `repeats` runs of 5 repetitions."""
    times = {}
    for name, sub in cases:
        def run(sub=sub):
            for x, blocks, d in sub:
                eesp_stage.eesp_stage_fused_eval(x, blocks, d)
        times[name] = min(cs.time_ms(run) for _ in range(repeats))
    return times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="checkout to import chip_smoke and mspl_tpu_torch "
                         "from (default: this one)")
    ap.add_argument("--skip", default="",
                    help="comma-separated EESP_SKIP masks of trial builds "
                         "to time (default: none)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs a case, the least kept (default 3)")
    args = ap.parse_args()
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from mspl_tpu_torch.ops import _cuda, eesp_stage

    for mod in (cs, _cuda):
        if tree not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} came from {mod.__file__}, "
                             f"not from {tree}")
    smi = cs.phase_device()
    print(f"tree {tree}", flush=True)
    secs = _cuda.build_all(("eesp_stage",))
    log = _cuda.BUILD / "eesp_stage.log"
    print(f"build eesp_stage {secs:.1f} s | " + " | ".join(
        ptxas_lines(log) if log.exists() else ["no compiler log"]),
        flush=True)

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    err16, top_rms = cs.check_stage(gen)
    err32 = 0.0
    for x, blocks, d in (cs.stage_calls(8, torch.float32, gen)
                         + cs.dense_stage_calls(8, torch.float32, gen)):
        got = eesp_stage.eesp_stage_fused_eval(x, blocks, d)
        want = eesp_stage.eesp_stage_fused_eval_plain(x, blocks, d)
        rms = want.pow(2).mean().sqrt().item()
        err32 = max(err32, (got - want).abs().max().item() / rms)
    print(f"stage check passed (batch 8, main-path stages and the dense "
          f"chain): bf16 max |err| {err16:.4g} (rms up to {top_rms:.4g}), "
          f"fp32 max |err| / rms {err32:.3g}", flush=True)

    calls = cs.stage_calls(cs.BATCH, torch.bfloat16, gen)
    cases = [("level3, 3 units", calls[:1]), ("level4, 7 units", calls[1:2]),
             ("route, 30 launches", calls)]
    times = time_cases(cs, eesp_stage, cases, args.repeats)
    for name, sub in cases:
        b_ms, _, term = cs.bound(*cs.stage_work(sub))
        print(f"eesp_stage_fused_eval {name} (bf16, batch {cs.BATCH}): "
              f"{times[name]:.3f} ms, bound {b_ms:.3f} ms ({term}) on {smi}",
              flush=True)
    trials = {}
    masks = [int(m) for m in args.skip.split(",") if m]
    for mask, lib in skip_builds(_cuda, masks).items():
        saved = _cuda._libs.get("eesp_stage")
        _cuda._libs["eesp_stage"] = lib
        try:
            trials[mask] = time_cases(cs, eesp_stage, cases, args.repeats)
        finally:
            _cuda._libs["eesp_stage"] = saved
        print(f"EESP_SKIP={mask}: " + ", ".join(
            f"{k} {v:.3f} ms (full less this {times[k] - v:.3f})"
            for k, v in trials[mask].items()), flush=True)

    counts = hmma_counts(_cuda.lib_path("eesp_stage"), _cuda._nvcc())
    print("HMMA instructions: " + (", ".join(
        f"{k} {v}" for k, v in counts.items()) or "none"), flush=True)
    print(json.dumps({"card": smi, "tree": str(tree), "build_s": secs,
                      "bf16_err": err16, "fp32_err_over_rms": err32,
                      "ms": times, "skip_ms": trials, "hmma": counts}),
          flush=True)
    if args.tree is None and not sum(counts.values()):
        raise SystemExit("eesp_unit_kernel has no HMMA instruction: its "
                         "products do not run on the tensor cores")


if __name__ == "__main__":
    main()
