"""The kernels' byte and operation counts at the main path's shapes
(three bf16 ESPNetv2-s2.0 sources, batch 128, 256x480), by hand and
against the counts behind the port's kernel table."""

import pytest

from h100_bench.roofline import (fused_pseudo_cm, peaks, pyr_branches,
                                 pyr_pool_fused_eval, resize_x2_cm)
from h100_bench.roofline.shapes import Model, branch_sizes, model_key, planes

ESP = model_key({"name": "espnetv2", "s": 2.0, "dec_base_planes": 16})
MAIN = [Model(11, 2, ESP), Model(19, 2, ESP), Model(5, 2, ESP)]
HW, B = (256, 480), 128


def test_planes_and_branch_sizes():
    assert planes(HW) == [(16, 30), (32, 60), (64, 120), (128, 240)]
    assert branch_sizes(16, 30) == ((32, 60), (24, 45), (16, 30), (8, 15),
                                    (5, 5))


def test_fused_pass_bytes():
    # the logits once (128 x 256 x 480 x 35 channels x 2 bytes) and an
    # int32 label and f32 confidence a pixel: 1.227 GB
    calls = fused_pseudo_cm.calls(MAIN, HW, B, False)
    nbytes, ops, tc = fused_pseudo_cm.work(calls)
    px = B * 256 * 480
    assert nbytes == px * 35 * 2 + px * 8
    assert nbytes / 1e9 == pytest.approx(1.227, abs=5e-4)
    assert ops == px * (6 * 35 + 3 * 5 + 9 + 10) and tc == 0


def test_resize_bytes():
    calls = resize_x2_cm.calls(MAIN, HW, B, False)
    nbytes, ops, _ = resize_x2_cm.work(calls)
    assert nbytes == B * 35 * (128 * 240 + 256 * 480) * 2
    assert nbytes / 1e9 == pytest.approx(1.376, abs=5e-4)
    assert ops == 9 * B * 35 * 256 * 480


def test_resize_output_at_its_own_size():
    f32 = [Model(3, 4, ESP)]
    nbytes, _, _ = resize_x2_cm.work(resize_x2_cm.calls(f32, HW, 8, False))
    assert nbytes == 8 * 3 * (128 * 240 + 256 * 480) * 4


def test_branch_stack_bytes():
    calls = pyr_branches.calls(MAIN, HW, B, False)
    assert len(calls) == 9  # 3 blocks a source in eval
    nbytes, _, _ = pyr_branches.work(calls)
    assert nbytes / 1e9 == pytest.approx(0.387, abs=5e-4)
    assert len(pyr_branches.calls(MAIN[:1], HW, 8, True)) == 4


def test_tail_bound_is_operations():
    calls = pyr_pool_fused_eval.calls(MAIN, HW, B, False)
    assert [(p, o) for _, p, o, *_ in calls] == [(8, 11), (9, 19), (8, 5)]
    ms, by = peaks.bound_ms(*pyr_pool_fused_eval.work(calls))
    assert by == "f32 operations"
    assert ms == pytest.approx(0.560, abs=5e-3)


def test_bound_takes_the_largest_term():
    assert peaks.bound_ms(3.35e9, 0.0) == pytest.approx((1.0, "bytes"))
    assert peaks.bound_ms(0.0, 67e9)[1] == "f32 operations"
    assert peaks.bound_ms(0.0, 0.0, 989e9)[1] == "bf16 products"


def test_model_reads_its_widths_from_the_configuration():
    m = Model(3, 4, model_key({"name": "espnetv2", "s": 2.0,
                               "dec_base_planes": 32}))
    assert m.espnetv2 and m.dec_base_planes == 32
    assert model_key({"b": [1, 2], "a": 1}) == (("a", 1), ("b", (1, 2)))
    dl = Model(3, 4, model_key({"name": "deeplabv3",
                                "stage_blocks": [3, 4, 6, 3]}))
    assert not dl.espnetv2 and dl.spec["stage_blocks"] == (3, 4, 6, 3)
    # a model without an ESPNetv2 decoder makes no call of ② ③ ④
    for mod in (pyr_branches, pyr_pool_fused_eval, resize_x2_cm):
        assert mod.calls([dl], HW, 8, False) == []
