"""The `segformer_b5` configuration's files at a tiny size on the CPU: its
weights' bits for a seed, its dense count against the closed form at the
cell's shapes, its file's exports, a sound fine-tune and each planted
fault under the cell's own limits, the control failing them, and the
three readers of the SegFormer's spans on hand-built traces.  The
contract's checks of its cell are `test_h100_bench_contract.py`'s, which
take every cell of `BENCHMARK.json`."""

import copy
import json

import pytest
import torch

from h100_bench import common, control, layers_read, run
from h100_bench.reference import pipeline as ref
from h100_bench.roofline.shapes import model_key
from h100_bench.tests import tiny
from h100_bench.tests.test_h100_bench_faults import (altered_loss,
                                                     half_batch_loss,
                                                     unchanged_state)
from h100_bench.tests.test_h100_bench_models import state_sha
from h100_bench.tests.test_h100_bench_spans import _reading, _view
from h100_bench.weights import make_state, shapes_of

CELL = "segformer_b5.finetune_b8"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
HW = [64, 96]
SEG = {"model": {"name": "segformer", "embed_dims": [16, 32, 40, 64],
                 "num_heads": [1, 2, 5, 8], "depths": [1, 1, 2, 1],
                 "sr_ratios": [8, 4, 2, 1], "mlp_ratio": 4,
                 "decoder_dim": 32, "drop_path_rate": 0.0,
                 "head_dropout": 0.0},
       "image_hw": HW, "target": {"classes": 3, "dtype": "float32"}}
# sha256 of `make_state` at SEG's sizes, 3 classes (seed -> digest)
STATE_SHA = {
    7: "93341e95e4fd22373208a34848ef6b89fcb88a33ec13b6f13d9f296c069564ba",
    2147483725:
        "62e32efb42fc0fda05a10576383ac0911eeb24d66b8deeb67b1ca789c5e8488a",
}
READERS = ["attention_ms.train", "mix_ffn_ms.train", "decode_head_ms.train"]


@pytest.mark.parametrize("seed", sorted(STATE_SHA))
def test_same_seed_same_bits(seed):
    with torch.device("meta"):
        shapes = shapes_of(ref.build_model(SEG["model"], 3, torch.float32))
    assert state_sha(make_state("segformer", shapes, seed, CPU)) == \
        STATE_SHA[seed]


def closed_form(spec, classes, hw) -> int:
    """An eval forward's products (2 a multiply-add) of one image: per
    block q, proj, kv, the reduction's linear layer, the two attention
    products, fc1 and fc2; the head's linear layers, `linear_fuse` and
    `linear_pred`."""
    h, w = hw
    dim, ratio = spec["decoder_dim"], spec["mlp_ratio"]
    total, stages = 0, []
    for i, (c, depth, r) in enumerate(zip(spec["embed_dims"],
                                          spec["depths"],
                                          spec["sr_ratios"])):
        k, s = (7, 4) if i == 0 else (3, 2)
        h, w = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
        n, m = h * w, (h // r) * (w // r)
        block = (2 * n * c * c * 2 + 2 * m * c * 2 * c
                 + (2 * m * c * r * r * c if r > 1 else 0)
                 + 2 * 2 * n * m * c + 2 * 2 * n * c * ratio * c)
        total += depth * block
        stages.append((n, c))
    n1 = stages[0][0]
    total += sum(2 * n * c * dim for n, c in stages)
    return total + 2 * n1 * len(stages) * dim * dim + 2 * n1 * dim * classes


def test_dense_counts_at_the_cells_shapes():
    """The cell's model (B5) at its crop: an eval forward of one image,
    and a train step of the cell's batch, which counts each product three
    times (forward, and the gradients of both operands)."""
    cell = common.load_cell(CELL)
    spec, tr = cell.config["model"], cell.traffic
    crop = tuple(tr["crop_hw"])
    one = closed_form(spec, 3, crop)
    assert layers_read._conv_flops(model_key(spec), 3, "float32", 1, crop,
                                   False) == one
    assert layers_read._conv_flops(model_key(spec), 3, "float32",
                                   tr["batch"], crop, True) == \
        3 * tr["batch"] * one
    assert round(one / 1e9, 3) == 95.957
    assert round(3 * tr["batch"] * one / 1e12, 4) == 2.3030


def test_model_file_exports_what_the_harness_reads():
    mod = ref.model_module("segformer")
    assert isinstance(mod.MODEL, type) and mod.DENSE_OPS == ("mm",)
    law = mod.weight_law
    assert law("backbone.block1.0.attn.q.weight", (64, 64)) == \
        ("normal", 0.02)
    assert law("backbone.block1.0.mlp.dwconv.dwconv.weight",
               (256, 1, 3, 3)) == ("normal", (2 / 9) ** 0.5)
    assert law("backbone.block1.0.attn.sr.weight", (64, 64, 8, 8)) == \
        ("normal", (2 / (64 * 64)) ** 0.5)
    assert law("decode_head.linear_c4.proj.weight", (768, 512)) == \
        ("normal", (1 / (3 * 512)) ** 0.5)
    assert law("decode_head.linear_fuse.conv.weight", (768, 3072, 1, 1)) \
        == ("normal", (2 / 768) ** 0.5)
    assert law("backbone.norm4.weight", (512,)) == ("const", 1.0)
    assert law("backbone.norm4.bias", (512,)) == ("const", 0.0)
    with pytest.raises(ValueError, match="at 0"):
        mod.MODEL(3, drop_path_rate=0.1)


def _cell():
    tr = tiny.shrink_finetune(common.load_json(
        common.HERE / "traffic" / "finetune_b8.json"))
    tr["crop_hw"] = HW
    lim = common.load_json(common.HERE / "limits" / f"{CELL}.json")
    return common.Cell(CELL, copy.deepcopy(SEG), tr, limits=lim["limits"])


def _run(cell, capsys):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "0.5", "--trace", "0"], device=CPU, cell=cell)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(capsys):
    line = _run(_cell(), capsys)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("fault", [unchanged_state, half_batch_loss,
                                   altered_loss],
                         ids=lambda f: f.__name__)
def test_broken_path_is_not_correct(fault, capsys):
    with fault():
        line = _run(_cell(), capsys)
    assert line["correct"] is False, line["checks"]


def test_control_fails_the_limits(capsys):
    cell = _cell()
    control.main(["--workload", CELL, "--seeds", "5"], device=CPU,
                 cell=cell)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["reading"] for x in lines] == ["control", "half_batch"]
    for line in lines:
        over = [k for k, lim in cell.limits.items() if k in line["values"]
                and not line["values"][k] <= lim]
        assert over, line


def test_readers_take_the_kernels_launched_under_their_spans():
    # kernel 1 launches at 60, kernel 2 at 320, kernels 3 and 4 at 700
    # and 720 (`test_h100_bench_spans.py`'s device)
    view = _view(("mspl.segformer.attn:1", 50, 70),
                 ("mspl.segformer.ffn:3", 300, 330),
                 ("mspl.segformer.attn:4", 690, 710),
                 ("mspl.segformer.head", 715, 730))
    got = {n: layers_read._reader(n).read(_reading(view)) for n in READERS}
    assert got == pytest.approx({"attention_ms.train": 0.1,
                                 "mix_ffn_ms.train": 0.1,
                                 "decode_head_ms.train": 0.105})


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_the_spans(name):
    view = _view(("mspl.train.forward", 0, 900), ("h100_bench.model", 0, 900))
    assert layers_read._reader(name).read(_reading(view)) is None
