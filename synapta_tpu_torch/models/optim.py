"""The two optax pieces both trainers use, on torch.optim.

- ``adamw``: ``optax.adamw`` as ``torch.optim.AdamW`` with optax's defaults
  (weight decay 1e-4 on every parameter, eps 1e-8; torch's default decay is
  1e-2). Both decay by lr × weight_decay × the parameter before the step.
- ``warmup_cosine_decay_schedule``: ``optax.warmup_cosine_decay_schedule``
  as a count -> value function, which drives a ``LambdaLR``. optax evaluates
  the schedule at the count of previous updates, so the first update has
  the schedule's value at 0 (0 for a warmup from 0); so does ``AdamW.step``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import torch
from torch.optim.lr_scheduler import LambdaLR


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
) -> Callable[[int], float]:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to 0 at ``decay_steps`` (which
    includes the warmup), held there after: optax's schedule with its
    default end value and exponent. Raises as optax does when
    ``decay_steps <= warmup_steps``."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got"
            f" decay_steps={decay_steps - warmup_steps}."
        )
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(float(count - warmup_steps), cos_steps)
        return peak_value * 0.5 * (1.0 + math.cos(math.pi * t / cos_steps))

    return schedule


class AdamW(NamedTuple):
    """A torch AdamW whose learning rate follows a schedule by update count."""

    opt: torch.optim.AdamW
    sched: LambdaLR

    def step(self) -> None:
        """Apply one update from the parameters' gradients, then move the
        learning rate to the schedule's next count."""
        self.opt.step()
        self.sched.step()


def adamw(
    params,
    learning_rate: Union[float, Callable[[int], float]],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> AdamW:
    """``optax.adamw(learning_rate, b1, b2, eps, weight_decay=1e-4)``: the
    update is -lr × (m̂ / (√v̂ + eps) + weight_decay × param) on every
    parameter, lr a float or a schedule of the update count."""
    schedule = learning_rate if callable(learning_rate) else (
        lambda count: learning_rate)
    opt = torch.optim.AdamW(params, lr=1.0, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)
    # LambdaLR sets lr = 1.0 × schedule(count), starting at count 0
    return AdamW(opt, LambdaLR(opt, schedule))
