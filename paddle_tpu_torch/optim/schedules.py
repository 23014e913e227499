"""Learning-rate schedules (port of `resolve` and the constant schedule
of `paddle_tpu.optim.schedules`). A schedule maps the step (an int32
0-d tensor) to the learning rate as an f32 0-d tensor on the step's
device, so an update never syncs with the host."""

from __future__ import annotations

from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def resolve(lr) -> Schedule:
    if callable(lr):
        return lr
    return constant(float(lr))
