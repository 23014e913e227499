"""Evaluator base types (reference: gserver/evaluators/Evaluator.h).

The reference's Evaluator contract is start/eval-per-batch/finish with a
printable result; ours is reset/update/result. Evaluators are host-side
streaming objects; anything per-batch and dense should be computed
in-graph (ops.metrics / metrics.classify accumulators) and fed to
`update` as small host arrays.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Sequence


class Evaluator(abc.ABC):
    name: str = "evaluator"

    @abc.abstractmethod
    def reset(self) -> None:
        ...

    @abc.abstractmethod
    def update(self, *args, **kwargs) -> None:
        ...

    @abc.abstractmethod
    def result(self) -> Any:
        ...

    def __repr__(self) -> str:
        return f"{self.name}={self.result()}"


class CombinedEvaluator(Evaluator):
    """Fan out update() to several evaluators and merge their results
    (reference: NeuralNetwork.cpp:332 CombinedEvaluator)."""

    name = "combined"

    def __init__(self, evaluators: Sequence[Evaluator]):
        self.evaluators = list(evaluators)

    def reset(self) -> None:
        for ev in self.evaluators:
            ev.reset()

    def update(self, *args, **kwargs) -> None:
        for ev in self.evaluators:
            ev.update(*args, **kwargs)

    def result(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        seen: Dict[str, int] = {}
        for ev in self.evaluators:
            # same-named members become "name#1" etc. rather than silently
            # overwriting
            count = seen.get(ev.name, 0)
            seen[ev.name] = count + 1
            key = ev.name if count == 0 else f"{ev.name}#{count}"
            out[key] = ev.result()
        return out
