"""Learning-rate schedules (port of `paddle_tpu.optim.schedules`).

Parity with the reference's LR schedulers (constant, poly, caltechFeature
(= inv), exp, discexp, linear, manual) plus linear warmup with cosine
decay. A schedule maps the step (an int32 0-d tensor) to the learning
rate as an f32 0-d tensor on the step's device, with the JAX package's
formulas; none of them syncs with the host, so an update never waits on
the card.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _f32(step: torch.Tensor) -> torch.Tensor:
    return step.to(torch.float32)


def constant(lr: float) -> Schedule:
    # a fill on the device: torch.tensor(lr, device=...) would copy from
    # the host and wait for the stream
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def poly(lr: float, a: float, b: float) -> Schedule:
    """lr * (1 + a*step)^(-b) (reference: poly schedule)."""
    return lambda step: lr * torch.pow(1.0 + a * _f32(step), -b)


def inv(lr: float, gamma: float, power: float) -> Schedule:
    """Caffe-style inv, the reference's caltech_feature schedule."""
    return lambda step: lr * torch.pow(1.0 + gamma * _f32(step), -power)


def exp_decay(lr: float, a: float, b: float) -> Schedule:
    """lr * a^(step/b) (reference: exp schedule)."""
    return lambda step: lr * torch.pow(a, _f32(step) / b)


def discrete_exp(lr: float, a: float, b: float) -> Schedule:
    """lr * a^floor(step/b) (reference: discexp schedule)."""
    return lambda step: lr * torch.pow(a, torch.floor(_f32(step) / b))


def linear_decay(lr: float, a: float, b: float) -> Schedule:
    """max(lr - a*step, b) (reference: linear schedule)."""
    return lambda step: torch.clamp(lr - a * _f32(step), min=b)


def piecewise(boundaries: Sequence[int], values: Sequence[float]
              ) -> Schedule:
    """Manual step schedule (reference: manual/pass_manual schedules,
    segments 'step1:lr1,step2:lr2,...'): values[i] from boundaries[i-1]
    on. The segment is found on the device (a count and a gather); the
    tables are copied to a device once, at its first call there."""
    tables = {}
    last = len(values) - 1

    def fn(step):
        if step.device not in tables:
            tables[step.device] = (
                torch.tensor(list(boundaries), dtype=torch.int32,
                             device=step.device),
                torch.tensor(list(values), dtype=torch.float32,
                             device=step.device))
        bs, vs = tables[step.device]
        idx = torch.sum((step >= bs).to(torch.int32))
        return vs[torch.clamp(idx, 0, last)]

    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 0.0) -> Schedule:
    """Linear warmup then cosine decay to min_lr (no reference
    counterpart)."""

    def fn(step):
        s = _f32(step)
        warm = lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_lr + 0.5 * (lr - min_lr) * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, cos)

    return fn


def resolve(lr) -> Schedule:
    if callable(lr):
        return lr
    return constant(float(lr))
