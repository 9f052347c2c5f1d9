"""Learning-rate schedules (port of mspl_tpu/engine/schedules.py): poly
decay, step, cyclic, hybrid (cyclic restarts, then linear decay), linear
and fixed, as plain functions of the step count -> float.

The JAX package builds them from optax's schedules; these are the same
formulas written out (`_polynomial` is optax's `polynomial_schedule`,
`step_schedule` its staircase `exponential_decay`).  The step count is the
number of optimizer updates already made, optax's `count`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def _polynomial(init_value: float, end_value: float, power: float,
                transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda step: init_value

    def fn(step):
        count = min(max(step, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac ** power + end_value

    return fn


def poly_schedule(base_lr: float, total_steps: int,
                  power: float = 0.9) -> Schedule:
    frac = _polynomial(1.0, 0.0, 1.0, total_steps)
    return lambda step: base_lr * frac(step) ** power


def step_schedule(base_lr: float, step_size: int,
                  gamma: float = 0.5) -> Schedule:
    if step_size <= 0 or gamma == 0:
        return lambda step: base_lr
    return lambda step: (base_lr if step <= 0 else
                         base_lr * gamma ** math.floor(step / step_size))


def cyclic_schedule(base_lr: float, max_lr: float,
                    cycle_len: int) -> Schedule:
    """Triangular cyclic lr between base_lr and max_lr, period cycle_len."""
    def fn(step):
        pos = (step % cycle_len) / max(cycle_len - 1, 1)
        tri = 1.0 - abs(2.0 * pos - 1.0)  # 0 -> 1 -> 0 over the cycle
        return base_lr + (max_lr - base_lr) * tri

    return fn


def hybrid_schedule(base_lr: float, max_lr: float, cycle_len: int,
                    cycle_steps: int, total_steps: int) -> Schedule:
    """Cyclic restarts for `cycle_steps`, then linear decay to 0."""
    cyc = cyclic_schedule(base_lr, max_lr, cycle_len)
    lin = _polynomial(max_lr, 0.0, 1.0, max(total_steps - cycle_steps, 1))
    return lambda step: (cyc(step) if step < cycle_steps
                         else lin(step - cycle_steps))


def build_schedule(name: str, base_lr: float, total_steps: int,
                   steps_per_epoch: int = 1, power: float = 0.9,
                   step_epochs: int = 30, gamma: float = 0.5,
                   max_lr: Optional[float] = None, cycle_epochs: int = 5,
                   cycle_frac: float = 0.5) -> Schedule:
    """A step -> lr schedule by name (the JAX package's SCHEDULER_NAMES)."""
    max_lr = max_lr if max_lr is not None else base_lr * 5.0
    if name == "poly":
        return poly_schedule(base_lr, total_steps, power)
    if name == "step":
        return step_schedule(base_lr, step_epochs * steps_per_epoch, gamma)
    if name == "cyclic":
        return cyclic_schedule(base_lr, max_lr, cycle_epochs * steps_per_epoch)
    if name == "hybrid":
        return hybrid_schedule(base_lr, max_lr, cycle_epochs * steps_per_epoch,
                               int(total_steps * cycle_frac), total_steps)
    if name == "linear":
        return _polynomial(base_lr, 0.0, 1.0, total_steps)
    if name == "fixed":
        return lambda step: base_lr
    raise ValueError(f"unknown scheduler '{name}'")
