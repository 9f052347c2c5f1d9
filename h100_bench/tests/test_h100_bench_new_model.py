"""A new model enters the benchmark as files alone.  A copy of the
benchmark gains the toy model of `tests/toy/` (a convolution, linear
layers, LayerNorm and one attention through `Numerics.matmul`, with its
weight laws and dense-op families) as `reference/models/toy.py`, its
configuration, its two cells' limits and their entries in
`BENCHMARK.json`; then a tiny fine-tune and a tiny target sweep of it run
through the drivers that `tiny.py`'s cells run through, with the port's
factory building the toy class.  Both are correct, the whole step's share
counts the toy's linear and attention products, and no file the copy had
changed."""

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from h100_bench import common

TOY = common.HERE / "tests" / "toy"
# each toy cell reports the metrics of the cell it is built like
TWINS = {"toy.finetune_b8": "deeplabv3_r50.finetune_b8",
         "toy.sweep_r1_b8": "deeplabv3_r50.sweep_r1_b8"}
WIDTH, HEADS, CLASSES, BATCH, HW, PATCH = 16, 2, 3, 2, (32, 48), 4

SCRIPT = r"""
import contextlib, copy, io, json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from h100_bench import common, layers_read, run
from h100_bench.reference import pipeline
from h100_bench.roofline.shapes import model_key
from h100_bench.tests import tiny
import mspl_tpu_torch.models.factory as factory

toy = pipeline.model_module("toy")
port_build = factory.build_segmentation_model


def build(name, classes, compute_dtype=torch.float32, **kw):
    if name != "toy":
        return port_build(name, classes, compute_dtype=compute_dtype, **kw)
    return toy.MODEL(classes, compute_dtype=compute_dtype, **kw)


factory.build_segmentation_model = build
out = {}
for name, shrink, seconds, trace in (
        ("toy.finetune_b8", tiny.shrink_finetune, 2, 1),
        ("toy.sweep_r1_b8", tiny.shrink_sweep, 0.5, 0)):
    cell = common.load_cell(name)
    cell.traffic = shrink(cell.traffic)
    cell.configs["espnetv2_s2"] = copy.deepcopy(tiny.ESP)
    cell.launches = {}  # the CPU launches no kernel
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", name, "--seed", str(2 ** 31 + 91),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device=torch.device("cpu"), cell=cell)
    out[name] = {"rc": rc, "line": json.loads(
        buf.getvalue().strip().splitlines()[-1])}
spec = common.load_json(common.HERE / "configs" / "toy.json")["model"]
out["flops"] = layers_read._conv_flops(model_key(spec), %d, "float32", %d,
                                       %r, False)
print(json.dumps(out))
""" % (CLASSES, BATCH, HW)


def _hashes(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _add_toy(bench: dict) -> dict:
    bench = copy.deepcopy(bench)
    bench["configs"].append({
        "name": "toy", "source": "a toy model of the benchmark's own tests",
        "file": "h100_bench/configs/toy.json", "reduced": [],
        "why": "a convolution, linear layers, LayerNorm and attention"})
    for cell, twin in TWINS.items():
        bench["workloads"].append({
            "name": cell, "config": "toy", "traffic": cell.split(".")[1],
            "chips": 1, "why": "the toy model as " + twin + " runs it"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if twin in m.get("workloads", []):
                m["workloads"].append(cell)
    return bench


def _without_toy(bench: dict) -> dict:
    bench = copy.deepcopy(bench)
    bench["configs"] = [c for c in bench["configs"] if c["name"] != "toy"]
    bench["workloads"] = [w for w in bench["workloads"]
                          if w["config"] != "toy"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in TWINS]
    return bench


def _hand_flops() -> int:
    """The toy's eval forward: the patch convolution, the qkv, projection
    and classifier products, attention's two (2 a multiply-add)."""
    n = (HW[0] // PATCH) * (HW[1] // PATCH)
    d = WIDTH // HEADS
    conv = 2 * BATCH * n * WIDTH * 3 * PATCH * PATCH
    linear = 2 * BATCH * n * WIDTH * (3 * WIDTH + WIDTH + CLASSES)
    attention = 2 * (2 * BATCH * HEADS * n * n * d)
    return conv + linear + attention


def test_a_model_is_added_by_files_alone(tmp_path):
    co = tmp_path / "checkout"
    shutil.copytree(common.HERE, co / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(common.ROOT / "BENCHMARK.json", co / "BENCHMARK.json")
    os.symlink(common.ROOT / "mspl_tpu_torch", co / "mspl_tpu_torch")
    before = _hashes(co / "h100_bench")
    bench = common.load_json(co / "BENCHMARK.json")

    hb = co / "h100_bench"
    added = {hb / "reference" / "models" / "toy.py": TOY / "toy.py",
             hb / "configs" / "toy.json": TOY / "toy.json"}
    for cell in TWINS:
        added[hb / "limits" / f"{cell}.json"] = TOY / f"{cell}.json"
    for dst, src in added.items():
        assert not dst.exists(), dst
        shutil.copy(src, dst)
    (co / "BENCHMARK.json").write_text(json.dumps(_add_toy(bench), indent=2))

    out = subprocess.run([sys.executable, "-c", SCRIPT, str(co)],
                         capture_output=True, text=True, timeout=600,
                         cwd=co)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for cell in TWINS:
        assert res[cell]["rc"] == 0
        line = res[cell]["line"]
        assert line["correct"] is True, (cell, line["checks"])
        assert line["attempted"] > 0 and line["failed"] == 0
    assert "mfu.train" in res["toy.finetune_b8"]["line"]["metrics"]
    assert res["flops"] == _hand_flops()

    after = _hashes(co / "h100_bench")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        str(p.relative_to(hb)) for p in added}
    final = common.load_json(co / "BENCHMARK.json")
    assert _without_toy(final) == bench
