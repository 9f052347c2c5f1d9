"""The port's profiling and workload-config utilities
(`utils/profiling.py`, `utils/config.py`) against the JAX package's on the
CPU, and the command line's model card.

`estimate_flops` counts what `FlopCounterMode` sees, the convolutions and
matrix products; the JAX package's XLA cost analysis also counts the
elementwise work, so the port's count reads a few percent low: 0.942 of
JAX's on the small model below, 0.975 on the main path's s=2.0 source at
256x480.  The test holds the ratio inside [0.9, 1.0]."""

import json
import os
import re

import jax.numpy as jnp
import pytest
import torch

from mspl_tpu.cli import _print_model_card as jax_model_card
from mspl_tpu.models import ESPNetv2Segmentation as FlaxESPNetv2
from mspl_tpu.models import init_model as jax_init
from mspl_tpu.utils import config as jax_config
from mspl_tpu.utils import profiling as jax_profiling
from mspl_tpu_torch.cli import _print_model_card
from mspl_tpu_torch.models.espnetv2 import ESPNetv2Segmentation
from mspl_tpu_torch.utils.config import WORKLOADS, get_workload
from mspl_tpu_torch.utils.flax_bridge import flax_variables
from mspl_tpu_torch.utils.profiling import (StepTimer, device_sync,
                                            estimate_flops,
                                            model_parameters, trace)

# (classes, s, H x W): a small model, then the main path's s=2.0 source
MODELS = ((5, 0.5, (64, 96)), (19, 2.0, (256, 480)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("classes,s,hw", MODELS, ids=["s0.5", "s2.0"])
def test_model_parameters_and_flops_against_jax(classes, s, hw):
    """The parameter count equals JAX's, of the module and of its flax
    tree (77,903 and 787,056); the FLOPs lie within [0.9, 1.0] of JAX's
    estimate."""
    model = FlaxESPNetv2(num_classes=classes, s=s)
    variables = jax_init(model, hw)
    want_params = jax_profiling.model_parameters(variables["params"])
    want_flops = jax_profiling.estimate_flops(
        lambda v, x: model.apply(v, x, train=False), variables,
        jnp.zeros((1, *hw, 3), jnp.float32))
    port = ESPNetv2Segmentation(classes, s=s)
    assert model_parameters(port) == want_params
    assert model_parameters(flax_variables(port)["params"]) == want_params
    flops = estimate_flops(port, torch.zeros(1, 3, *hw))
    assert 0.9 <= flops / want_flops <= 1.0, flops / want_flops


def test_estimate_flops_leaves_the_model_as_it_was():
    """The count runs on a CPU copy in eval mode: the model keeps its mode
    and its weights."""
    port = ESPNetv2Segmentation(5, s=0.5).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    estimate_flops(port, torch.zeros(2, 3, 32, 48))
    assert port.training
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_step_timer_summary_matches_jax():
    times = [0.02, 0.05, 0.01, 0.04, 0.03]
    port, ref = StepTimer(), jax_profiling.StepTimer()
    port.times, ref.times = list(times), list(times)
    assert port.summary() == ref.summary()
    assert sorted(port.summary()) == ["mean_s", "p50_s", "p95_s", "steps",
                                      "total_s"]
    assert StepTimer().summary() == jax_profiling.StepTimer().summary() == {
        "steps": 0}
    timer = StepTimer()
    for _ in range(3):
        with timer.step():
            device_sync({"a": [torch.ones(3)], "b": (torch.zeros(1),)})
    assert timer.summary()["steps"] == 3 and len(timer.times) == 3


def test_trace_writes_a_profile(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    files = os.listdir(tmp_path / "tr")
    assert any(f.endswith(".pt.trace.json") for f in files), files
    with open(tmp_path / "tr" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert prof.key_averages()


def test_workloads_match_jax():
    assert list(WORKLOADS) == list(jax_config.WORKLOADS)
    for name, w in WORKLOADS.items():
        assert w.to_dict() == jax_config.WORKLOADS[name].to_dict(), name
        assert get_workload(name) == w
    with pytest.raises(ValueError) as got:
        get_workload("nope")
    with pytest.raises(ValueError) as want:
        jax_config.get_workload("nope")
    assert str(got.value) == str(want.value)


def test_model_card_prints_params_and_gflops_as_the_reference(capsys):
    """The port's card and the JAX CLI's on the same architecture: the
    same format and parameter count, GFLOPs within [0.9, 1.0]."""
    hw = MODELS[0][2]
    model = FlaxESPNetv2(num_classes=5, s=0.5)
    jax_model_card(model, jax_init(model, hw), hw)
    want = capsys.readouterr().out
    _print_model_card(ESPNetv2Segmentation(5, s=0.5), hw)
    got = capsys.readouterr().out
    pat = re.compile(r"model: ([\d.]+) M params, ([\d.]+) GFLOPs @ 96x64")
    (gp, gf), (wp, wf) = pat.findall(got)[0], pat.findall(want)[0]
    assert gp == wp
    assert 0.9 <= float(gf) / float(wf) <= 1.0
