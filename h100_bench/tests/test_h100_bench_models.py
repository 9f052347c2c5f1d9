"""A reference model is found by its configuration's name: its weights
come from the laws in its own file, the same bits for the same seed as
before the laws moved there, and the whole step's share counts the dense
op families its file declares, the same counts as before for today's
models.  The controls round the operands of linear layers and matrix
products as they round a convolution's."""

import hashlib

import pytest
import torch
import torch.nn.functional as F

from h100_bench import common, layers_read
from h100_bench.drivers.sweep import members
from h100_bench.reference import layers
from h100_bench.reference import pipeline as ref
from h100_bench.roofline.shapes import model_key
from h100_bench.tests import tiny
from h100_bench.weights import make_state, shapes_of

CPU = torch.device("cpu")

# sha256 of `make_state` at tiny.py's sizes, taken before the laws moved
# into the model files (name / classes / seed)
STATE_SHA = {
    "espnetv2/11/7":
        "89cf3362bdb6f42dc3cc2cbf16647e720a055810879cb10e89e4dc8191ced694",
    "espnetv2/11/2147483725":
        "e122664eb5dfb910554f78f95cd044b006cc0ae76d3ac2995ef914c8a17f5231",
    "espnetv2/3/7":
        "87ac8cf513f569eb582ed65a25eea6a80cbbd0421d4fba111aaabb6553a3c2dc",
    "espnetv2/3/2147483725":
        "67750c246fbd3788b7a5f5e268642c6d05cc362424b2191b32fceb57d7dfbed8",
    "deeplabv3/11/7":
        "3b0c37403781ff87c935c3cf6a904612c7b1ae79aad44d9f207fac2bc3d96256",
    "deeplabv3/11/2147483725":
        "5e7eaf3d37a2a07cab61c021d0db4cc56003333a1f5b0638e69362da3e47b2d6",
    "deeplabv3/3/7":
        "be337b55fcbc7677205551e8608fbd8f84fb1f915fc758cb0d34e36b518130ff",
    "deeplabv3/3/2147483725":
        "a84678808e3c14dc9a4e0ec4e0a969dba2a05795de8df79cf18257a7d4ca20c0",
}

# `_conv_flops` of each model of the four cells at their own shapes, taken
# before the dense families moved into the model files
# (cell / model / classes / dtype)
FLOPS = {
    "espnetv2_s2.sweep_b128/espnetv2/11/bfloat16": 158322243584.0,
    "espnetv2_s2.sweep_b128/espnetv2/19/bfloat16": 160780206848.0,
    "espnetv2_s2.sweep_b128/espnetv2/5/bfloat16": 157944756224.0,
    "deeplabv3_r50.finetune_b8/deeplabv3/3/float32": 1333782380544.0,
    "espnetv2_s2.finetune_b8/espnetv2/3/float32": 119354401536.0,
    "deeplabv3_r50.sweep_r1_b8/espnetv2/11/bfloat16": 9895140224.0,
    "deeplabv3_r50.sweep_r1_b8/espnetv2/19/bfloat16": 10048762928.0,
    "deeplabv3_r50.sweep_r1_b8/espnetv2/5/bfloat16": 9871547264.0,
    "deeplabv3_r50.sweep_r1_b8/deeplabv3/3/float32": 446135533568.0,
}


def state_sha(state) -> str:
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(v.reshape(-1).contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("key", sorted(STATE_SHA))
def test_same_seed_same_bits(key):
    name, classes, seed = key.split("/")
    spec = {"espnetv2": tiny.ESP, "deeplabv3": tiny.DEEPLAB}[name]["model"]
    dtype = torch.bfloat16 if classes == "11" else torch.float32
    with torch.device("meta"):
        shapes = shapes_of(ref.build_model(spec, int(classes), dtype))
    assert state_sha(make_state(name, shapes, int(seed), CPU)) == \
        STATE_SHA[key]


def _cell_models():
    """(cell / model / classes / dtype, the arguments of `_conv_flops`) of
    every model of the four cells at their own shapes."""
    out = {}
    for w in common.load_json(common.ROOT / "BENCHMARK.json")["workloads"]:
        cell = common.load_cell(w["name"])
        tr = cell.traffic
        if tr["driver"] == "sweep":
            items = [(m.model, m.classes, str(m.dtype).split(".")[-1])
                     for m in members(cell)]
            shape = (tr["batch"], tuple(cell.config["image_hw"]), False)
        else:
            items = [(cell.config["model"], cell.config["target"]["classes"],
                      "float32")]
            shape = (tr["batch"], tuple(tr["crop_hw"]), True)
        for spec, classes, dtype in items:
            out[f"{w['name']}/{spec['name']}/{classes}/{dtype}"] = (
                model_key(spec), classes, dtype, *shape)
    return out


def test_same_dense_counts():
    got = {k: layers_read._conv_flops(*args)
           for k, args in _cell_models().items()}
    assert got == FLOPS


def test_unknown_model_names_its_missing_file():
    with pytest.raises(ValueError, match=r"models/no_such_net\.py"):
        ref.build_model({"name": "no_such_net"}, 3, torch.float32)
    with pytest.raises(ValueError, match="no reference model"):
        ref.model_module("../layers")


@pytest.mark.parametrize("name", ["espnetv2", "deeplabv3"])
def test_model_files_export_what_the_harness_reads(name):
    mod = ref.model_module(name)
    assert isinstance(mod.MODEL, type) and mod.DENSE_OPS == ("convolution",)
    assert mod.weight_law("a.bn.running_var", (4,)) == ("const", 1.0)
    assert mod.weight_law("a.conv.bias", (4,)) == ("const", 0.0)


def _operands(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 24, generator=g).to(dtype)
    w = torch.randn(16, 24, generator=g).to(dtype)
    b = torch.randn(16, generator=g)
    k = torch.randn(2, 24, 5, generator=g).to(dtype)
    return x, w, b, k


@pytest.mark.parametrize("num,rnd,dtype", [
    (layers.FP8Numerics(), layers.fp8_round, torch.bfloat16),
    (layers.TF32Numerics(), layers.tf32_round, torch.float32)])
def test_controls_round_linear_and_matmul_operands(num, rnd, dtype):
    x, w, b, k = _operands(dtype)
    plain = layers.PLAIN
    lin = num.linear(x, w, b)
    assert torch.equal(lin, F.linear(rnd(x), rnd(w).to(rnd(x).dtype),
                                     b.to(rnd(x).dtype)))
    assert not torch.equal(lin, plain.linear(x, w, b))
    mm = num.matmul(x, k)
    assert torch.equal(mm, torch.matmul(rnd(x), rnd(k)))
    assert not torch.equal(mm, plain.matmul(x, k))
    # the plain path computes in the activation's dtype
    assert plain.linear(x, w, b).dtype == dtype
    assert torch.equal(plain.matmul(x, k), torch.matmul(x, k))


def test_tf32_control_rounds_the_gradient_of_a_product():
    x, _, _, k = _operands(torch.float32)
    x.requires_grad_(True)
    layers.TF32Numerics().matmul(x, k).sum().backward()
    g = x.grad
    assert torch.equal(g, layers.tf32_round(g))
