"""Learning-rate schedules.

A copy of `differential_equations_resnet_tpu/train/schedules.py` (which
imports nothing of JAX, but the port imports nothing of the JAX package).
The reference passes a bare callable ``global_step -> lr`` re-evaluated every
step; any Python callable still works here.  These helpers provide the
common shapes as named constructors."""

from __future__ import annotations

from typing import Callable, Sequence

Schedule = Callable[[int], float]


def constant_schedule(learning_rate: float) -> Schedule:
    return lambda step: learning_rate


def piecewise_constant_schedule(
    boundaries: Sequence[int], values: Sequence[float]
) -> Schedule:
    """values[i] for step < boundaries[i]; values[-1] afterwards."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("need len(values) == len(boundaries) + 1")

    def schedule(step: int) -> float:
        for boundary, value in zip(boundaries, values):
            if step < boundary:
                return value
        return values[-1]

    return schedule


def exponential_decay_schedule(
    initial: float, decay_rate: float, decay_steps: int, staircase: bool = False
) -> Schedule:
    def schedule(step: int) -> float:
        exponent = step / decay_steps
        if staircase:
            exponent = int(exponent)
        return initial * (decay_rate ** exponent)

    return schedule


def linear_warmup_schedule(
    peak: float, warmup_steps: int, after: Schedule | None = None
) -> Schedule:
    """Linear ramp 0 -> ``peak`` over ``warmup_steps``, then ``after(step -
    warmup_steps)`` (default: constant ``peak``).  ``warmup_steps=0`` means
    no warmup: it returns ``after`` (default: the constant-``peak``
    schedule)."""
    if warmup_steps < 0:
        raise ValueError("warmup_steps must be >= 0")
    after = after or constant_schedule(peak)
    if warmup_steps == 0:
        return after

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak * (step + 1) / warmup_steps
        return after(step - warmup_steps)

    return schedule
