"""Trainer events (port of `paddle_tpu.train.events`): BeginPass /
EndPass / BeginIteration / EndIteration with cost and metrics, and
TestResult, as `Trainer.train(event_handler=...)` delivers them."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class BeginPass:
    pass_id: int


@dataclasses.dataclass
class EndPass:
    pass_id: int
    evaluator_results: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BeginIteration:
    pass_id: int
    batch_id: int


class EndIteration:
    """End-of-batch event with LAZY cost/metrics.

    The step's loss/metrics stay on the device; reading `.cost` or
    `.metrics` materializes them (one device sync). Handlers that only
    log every few batches therefore never stall the launch queue on the
    other batches.
    """

    __slots__ = ("pass_id", "batch_id", "outcome", "_cost", "_metrics")

    def __init__(self, pass_id: int, batch_id: int, cost: Any,
                 metrics: Optional[Dict[str, Any]] = None,
                 outcome: str = "ok"):
        self.pass_id = pass_id
        self.batch_id = batch_id
        # "ok" for a healthy step; a divergence guard closes a bad
        # iteration with the fault's disposition instead of leaving the
        # BeginIteration unmatched: "skip" | "rollback" | "fail"
        self.outcome = outcome
        self._cost = cost
        self._metrics = metrics or {}

    @property
    def cost(self) -> float:
        return float(self._cost)

    @property
    def metrics(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self._metrics.items()}

    def __repr__(self):
        return (f"EndIteration(pass_id={self.pass_id}, "
                f"batch_id={self.batch_id}, outcome={self.outcome!r}, "
                f"<lazy cost/metrics>)")


@dataclasses.dataclass
class TestResult:
    pass_id: int
    cost: float
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
