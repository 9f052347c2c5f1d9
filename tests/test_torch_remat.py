"""`make_train_step(remat=True)` on the CPU: the forward checkpointed
(`torch.utils.checkpoint`) and recomputed in the backward leaves every
number of the step as it is without remat.  Two SGD steps of ESPNetv2 and
of the small DeepLab, with one and two BatchNorm groups: the losses, the
parameters, the running statistics and `num_batches_tracked` bit for bit,
while a BatchNorm ran twice a step (the recompute, under frozen running
statistics and the step's group count)."""

import numpy as np
import pytest
import torch

from mspl_tpu_torch.engine.schedules import build_schedule
from mspl_tpu_torch.engine.train import create_train_state, make_train_step
from mspl_tpu_torch.models import (DeepLabV3, ESPNetv2Segmentation,
                                   init_model)
from tests.test_torch_train import CLASSES, MODEL_KW, _batches

MODELS = {"espnetv2": lambda: ESPNetv2Segmentation(CLASSES, **MODEL_KW),
          "deeplabv3": lambda: DeepLabV3(CLASSES, stage_blocks=(1, 1, 1, 1),
                                         aspp_features=16)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's CPU ops on two threads for this module (see
    tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, remat, groups):
    """Two SGD steps from seed 0's weights: (losses, state dict, the
    number of times the first BatchNorm ran)."""
    model = init_model(MODELS[name](), torch.Generator().manual_seed(0))
    bn = next(m for m in model.modules()
              if isinstance(m, torch.nn.BatchNorm2d))
    calls = []
    bn.register_forward_hook(lambda *_: calls.append(1))
    state = create_train_state(model, "sgd", build_schedule(
        "hybrid", 0.005, 6, max_lr=0.01, cycle_epochs=3), device="cpu")
    step = make_train_step(model, augment=False, remat=remat,
                           bn_groups=groups, device="cpu")
    losses = []
    for batch in _batches(2):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    return losses, model.state_dict(), len(calls)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("name", list(MODELS))
def test_remat_leaves_the_step_bit_equal(name, groups):
    want_losses, want, want_calls = _run(name, False, groups)
    losses, got, calls = _run(name, True, groups)
    assert losses == want_losses
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert any(k.endswith("num_batches_tracked") for k in got)
    assert (want_calls, calls) == (2, 4)
    assert np.isfinite(losses).all()
