"""Deterministic, seed-driven fault injection for training (port of the
training part of `paddle_tpu.testing.faults`).

`FaultPlan` is one switchboard: a test declares WHERE faults strike
(sample index, global batch index, nth checkpoint save) and wraps the
real component; every fault fires deterministically (once by default),
is recorded in `plan.fired`, and the wrapped component otherwise
behaves as before -- so a passing recovery test means the recovery path
ran, not that the fault missed. The faults:

- reader exceptions at sample k, or at a seeded random rate
  (`wrap_reader`);
- an all-NaN batch at global batch k (`wrap_batches`): every float
  column of the batch is NaN, so the NaN flows through forward and
  backward into the loss AND the gradients;
- a preemption: `preempt_signal` (SIGTERM) sent to this process right
  before batch k is consumed (`wrap_batches`);
- an OSError on the nth checkpoint save (`wrap_checkpoint_manager`).

The serving, router, fleet, cluster, pserver, data-plane and master
faults of the JAX package wait for the layers they wrap (ROADMAP queue 1
items 4-6).
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
from typing import Any, Callable, List, Optional

import numpy as np
import torch


class FaultError(RuntimeError):
    """The exception injected faults raise: distinct from real errors, so
    tests can assert the failure they caused is the one handled."""


@dataclasses.dataclass
class FaultPlan:
    """Declarative fault schedule. All indices are 0-based; `once=True`
    (default) makes each fault fire a single time -- the recovery path
    must then succeed against an otherwise healthy component."""

    seed: int = 0
    reader_error_at: Optional[int] = None     # sample index
    reader_error_rate: float = 0.0            # seeded per-sample chance
    nan_batch_at: Optional[int] = None        # global batch index
    preempt_at: Optional[int] = None          # global batch index
    preempt_signal: int = signal.SIGTERM
    checkpoint_error_at: Optional[int] = None  # nth save() call
    once: bool = True
    fired: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._batch_counter = 0
        self._save_counter = 0

    # -- bookkeeping ------------------------------------------------------

    def _note(self, kind: str, detail: Any) -> None:
        self.fired.append(f"{kind}@{detail}")

    def count(self, kind: str) -> int:
        return sum(1 for f in self.fired if f.startswith(f"{kind}@"))

    def _spent(self, kind: str) -> bool:
        return self.once and self.count(kind) > 0

    # -- reader faults ----------------------------------------------------

    def wrap_reader(self, reader: Callable) -> Callable:
        """Wrap a data.reader-style reader (zero-arg callable returning
        an iterator): raises FaultError at sample `reader_error_at`
        and/or at a seeded `reader_error_rate` per sample. The faulted
        sample is NOT consumed from the inner reader -- a retried stream
        sees it again (no silent loss)."""
        plan = self

        def new_reader():
            for i, item in enumerate(reader()):
                hit = (plan.reader_error_at == i
                       and not plan._spent("reader"))
                if not hit and plan.reader_error_rate > 0:
                    hit = (plan._rng.random() < plan.reader_error_rate
                           and not plan._spent("reader"))
                if hit:
                    plan._note("reader", i)
                    raise FaultError(f"injected reader fault at "
                                     f"sample {i}")
                yield item

        return new_reader

    # -- batch-level faults (NaN poisoning, preemption) -------------------

    def wrap_batches(self, batch_iter_factory: Callable) -> Callable:
        """Wrap a batch_iter_factory (what Trainer/ResilientTrainer
        consume). The batch counter is GLOBAL across factory calls, so
        `nan_batch_at`/`preempt_at` address the run's global batch index
        across passes and rollback replays (a replayed index is poisoned
        again only with once=False)."""
        plan = self

        def factory():
            for batch in batch_iter_factory():
                idx = plan._batch_counter
                plan._batch_counter += 1
                if idx == plan.preempt_at and not plan._spent("preempt"):
                    plan._note("preempt", idx)
                    os.kill(os.getpid(), plan.preempt_signal)
                if idx == plan.nan_batch_at and not plan._spent("nan"):
                    plan._note("nan", idx)
                    batch = _poison_batch(batch)
                yield batch

        return factory

    # -- checkpoint faults ------------------------------------------------

    def wrap_checkpoint_manager(self, manager) -> "_FlakyCheckpoints":
        return _FlakyCheckpoints(manager, self)


def _poison_batch(batch):
    """Replace every float column of the batch (numpy array or tensor,
    on its device) with NaNs -- a genuinely divergent step (NaN forward,
    NaN loss, NaN grads), not a cosmetic one."""

    def poison(x):
        if isinstance(x, torch.Tensor):
            return (torch.full_like(x, float("nan"))
                    if x.is_floating_point() else x)
        arr = np.asarray(x)
        if np.issubdtype(arr.dtype, np.floating):
            return np.full_like(arr, np.nan)
        return x

    if isinstance(batch, tuple):
        return tuple(poison(x) for x in batch)
    return poison(batch)


class _FlakyCheckpoints:
    """CheckpointManager proxy: the `checkpoint_error_at`-th save()
    raises OSError (the full-disk / flaky-NFS case); everything else
    delegates."""

    def __init__(self, manager, plan: FaultPlan):
        self._manager = manager
        self._plan = plan

    def save(self, state, step: Optional[int] = None, **kwargs):
        idx = self._plan._save_counter
        self._plan._save_counter += 1
        if (idx == self._plan.checkpoint_error_at
                and not self._plan._spent("ckpt")):
            self._plan._note("ckpt", idx)
            raise OSError(f"injected checkpoint-write failure on "
                          f"save #{idx}")
        return self._manager.save(state, step, **kwargs)

    def __getattr__(self, name):
        return getattr(self._manager, name)
