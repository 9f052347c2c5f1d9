"""A run at a tiny size on the CPU (the look for a card skipped), sound and
with the timed path broken underneath: `correct` comes out true, then
false for each fault the cell can have, and the control (the reference in
the lower precision, in the program's place) fails the cell's limits."""

import contextlib

import pytest
import torch

from h100_bench import control, run
from h100_bench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def _run(cell, capsys):
    rc = run.main(["--workload", cell.name, "--seed", str(SEED),
                   "--seconds", "0.5", "--trace", "0"], device=CPU,
                  cell=cell)
    assert rc == 0
    import json
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(line)


def _cells():
    return {"sweep": tiny.sweep_cell(False), "sweep_target":
            tiny.sweep_cell(True), "finetune": tiny.finetune_cell(),
            "finetune_deeplab": tiny.finetune_cell("deeplab")}


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def half_batch_sweep():
    """Each batch's second half answered with its first half's results."""
    from mspl_tpu_torch.pseudo.generate import PseudoLabelGenerator
    orig = PseudoLabelGenerator.batch_pass

    def batch_pass(self, imgs):
        h = imgs.shape[0] // 2
        lab, conf = orig(self, imgs[:h])
        return torch.cat([lab, lab]), torch.cat([conf, conf])
    return patched(PseudoLabelGenerator, "batch_pass", batch_pass)


def altered_answer_sweep():
    """One image's labels moved to the next class where they are made."""
    from mspl_tpu_torch.pseudo import generate
    orig = generate.fused_pseudo_cm

    def fused(*a, **kw):
        lab, conf = orig(*a, **kw)
        lab = lab.clone()
        keep = lab[0] != 255
        lab[0] = torch.where(keep, (lab[0] + 1) % 3, lab[0])
        return lab, conf
    return patched(generate, "fused_pseudo_cm", fused)


def unchanged_state():
    """The optimizer's step returns with the state as it was."""
    return patched(torch.optim.SGD, "step", lambda self, closure=None: None)


def half_batch_loss():
    """The loss over the first half of each batch only."""
    import mspl_tpu_torch.engine.train as et
    orig = et.segmentation_loss

    def loss(logits, labels, *a, batch_mask=None, **kw):
        mask = torch.zeros(labels.shape[0], dtype=torch.bool,
                           device=labels.device)
        mask[: labels.shape[0] // 2] = True
        return orig(logits, labels, *a, batch_mask=mask, **kw)
    return patched(et, "segmentation_loss", loss)


def altered_loss():
    """The loss altered by 1% where it is produced."""
    import mspl_tpu_torch.engine.train as et
    orig = et.segmentation_loss
    return patched(et, "segmentation_loss",
                   lambda *a, **kw: orig(*a, **kw) * 1.01)


SOUND = ["sweep", "sweep_target", "finetune", "finetune_deeplab"]
FAULTS = [("sweep", half_batch_sweep), ("sweep", altered_answer_sweep),
          ("sweep_target", half_batch_sweep),
          ("sweep_target", altered_answer_sweep),
          ("finetune", unchanged_state), ("finetune", half_batch_loss),
          ("finetune", altered_loss),
          ("finetune_deeplab", unchanged_state),
          ("finetune_deeplab", half_batch_loss),
          ("finetune_deeplab", altered_loss)]


@pytest.mark.parametrize("name", SOUND)
def test_sound_run_is_correct(name, capsys):
    cell = _cells()[name]
    cell.launches = {}  # the CPU launches no kernel
    line = _run(cell, capsys)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_broken_path_is_not_correct(name, fault, capsys):
    cell = _cells()[name]
    cell.launches = {}
    with fault():
        line = _run(cell, capsys)
    assert line["correct"] is False, line["checks"]


def test_launch_counts_are_checked(capsys):
    cell = _cells()["sweep"]
    cell.launches = {"pyrpool.pyr_branches": 9}  # what the card launches a batch
    assert _run(cell, capsys)["checks"]["launch_excess"]["value"] > 0


@pytest.mark.parametrize("name", SOUND)
def test_control_fails_the_limits(name, capsys):
    cell = _cells()[name]
    control.main(["--workload", cell.name, "--seeds", "5"], device=CPU,
                 cell=cell)
    import json
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines
    for line in lines:
        over = [k for k, lim in cell.limits.items() if k in line["values"]
                and not line["values"][k] <= lim]
        assert over, line
