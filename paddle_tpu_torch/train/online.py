"""Streaming online learning: the taskqueue consumed with no pass barrier
(port of `paddle_tpu.train.online`; the one change: a lookup's rows,
which land on the backing's device, are copied to the host for the
gradient).

The batch trainers in this repo drain a pass, hit the `finish_pass`
barrier, and synchronize; a production CTR loop never stops — clicklog
shards stream in, sparse deltas stream out to the pserver tier, and the
SAME tables serve inference reads concurrently (bounded staleness: the
tiered cache re-validates against the shard watermarks every push
advances). `StreamingTrainer` is that loop:

- tasks come from the native taskqueue (`TaskQueue` or a `MasterClient`
  — same duck surface), each payload a JSON micro-batch spec;
- a `PASS_END` answer does NOT block on peers: the trainer immediately
  re-arms the queue (`next_pass`) and keeps consuming — the stream is
  the pass structure's degenerate continuous form;
- sparse deltas go through the embedding backing's shared lookup
  surface (`alltoall_push_row_grads` -> `PServerClient` epochs), so
  every push is exactly-once across reconnect, failover and lost ACK;
- a killed trainer REFORMS by constructing a fresh `StreamingTrainer`
  over a new client with the SAME trainer id: registration adopts the
  shard's applied-epoch watermark, so the resumed stream numbers its
  pushes past everything already applied — duplicates DUP out, nothing
  applies twice (the elastic-reform discipline at the push layer).

The default grad_fn is a logistic head over mean-pooled rows (the CTR
demo model); tests inject payload-deterministic grad functions when
they need bit-exact ledger reconciliation.

`fault_hook(event)` fires at "step" before each task fetch — the
testing.faults seam (`FaultPlan.wrap_online_trainer` +
`online_kill_step_at` kills the stream mid-flight there).
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.native.taskqueue import TaskStatus


def default_grad_fn(payload: dict, rows: np.ndarray, dim: int):
    """Logistic CTR head over mean-pooled embedding rows.

    payload: {"seed": int, "batch": int, "slots": int, "vocab": int}
    describes a deterministic synthetic clicklog micro-batch. Returns
    (ids [n*s], grads [n*s, dim]) with -1 on padding slots (dropped by
    the push path's shared padding contract)."""
    rng = np.random.RandomState(int(payload["seed"]))
    n = int(payload.get("batch", 8))
    s = int(payload.get("slots", 4))
    vocab = int(payload["vocab"])
    ids = rng.randint(0, vocab, size=(n, s)).astype(np.int64)
    labels = rng.randint(0, 2, size=n).astype(np.float32)
    flat = ids.reshape(-1)
    vecs = rows.reshape(n, s, dim)
    pooled = vecs.mean(axis=1)
    # fixed probe direction: train the table toward/away from it per
    # label — enough structure for scores to move, cheap enough for
    # the stream to be network-bound like production
    w = np.ones(dim, np.float32) / np.sqrt(dim)
    p = 1.0 / (1.0 + np.exp(-pooled @ w))
    g = ((p - labels) / s)[:, None] * w[None, :]     # [n, dim]
    grads = np.repeat(g, s, axis=0).astype(np.float32)
    return flat, grads


class StreamingTrainer:
    """Consume the taskqueue continuously, pushing sparse deltas.

    `queue` is a `TaskQueue`/`MasterClient`; `embedding` is any
    `LookupSurface` backing (production: `PServerEmbedding`); `table`
    its opaque handle. `grad_fn(payload, rows, dim) -> (ids, grads)`
    maps one task to its sparse delta — rows are pre-pulled for it via
    the backing's lookup surface so the gradient sees current state."""

    def __init__(self, queue, embedding, table, *, lr: float = 0.1,
                 grad_fn: Optional[Callable] = None,
                 fault_hook: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.queue = queue
        self.embedding = embedding
        self.table = table
        self.lr = float(lr)
        self.grad_fn = grad_fn if grad_fn is not None else default_grad_fn
        self.fault_hook = fault_hook
        self.clock = clock
        self._started = False
        self.stats: Dict[str, int] = {
            "steps": 0, "tasks_done": 0, "passes_streamed": 0,
            "waits": 0,
        }

    def bind_metrics(self, registry, *, prefix: str = "online_trainer",
                     labels=None) -> None:
        registry.register_source(prefix, lambda: dict(self.stats),
                                 labels=labels)

    def _fault(self, event: str) -> None:
        hook = self.fault_hook
        if hook is not None:
            hook(event)

    def step(self) -> bool:
        """Process ONE task. Returns True when a task was consumed (or
        a pass rolled over), False when the queue has nothing ready
        (todo drained but leases outstanding elsewhere)."""
        self._fault("step")
        if not self._started:
            self.queue.start()
            self._started = True
        status, tid, payload = self.queue.get_task()
        if status == TaskStatus.PASS_END:
            # the streaming discipline: no barrier, re-arm and continue
            self.queue.next_pass()
            self.queue.start()
            self.stats["passes_streamed"] += 1
            return True
        if status != TaskStatus.OK:
            self.stats["waits"] += 1
            return False
        spec = json.loads(payload.decode("utf-8"))
        dim = int(self.embedding.dim)
        # pre-pull current rows for the gradient (read path), then push
        # the sparse delta (write path) — both through the one shared
        # lookup surface, so this runs identically over pserver shards
        # or a host-offload table
        probe = default_probe_ids(spec)
        rows = self.embedding.alltoall_lookup(self.table, probe)
        if isinstance(rows, torch.Tensor):
            # the backing's rows land on its device: one explicit copy
            # back for the host-side gradient
            rows = rows.detach().cpu().numpy()
        rows = np.asarray(rows, np.float32)
        ids, grads = self.grad_fn(spec, rows, dim)
        self.table = self.embedding.alltoall_push_row_grads(
            self.table, ids, grads, self.lr)
        self.queue.finish_task(tid)
        self.stats["steps"] += 1
        self.stats["tasks_done"] += 1
        return True

    def run(self, max_steps: int, *,
            idle_sleep_s: float = 0.005) -> int:
        """Stream `max_steps` tasks (pass rollovers don't count as
        steps). Returns the number of tasks actually consumed."""
        done = 0
        while done < max_steps:
            before = self.stats["tasks_done"]
            if not self.step():
                time.sleep(idle_sleep_s)
                continue
            done += self.stats["tasks_done"] - before
        return done


def default_probe_ids(spec: dict) -> np.ndarray:
    """The ids a task's gradient will touch — regenerated from the
    payload exactly as `default_grad_fn` does, so the pre-pull and the
    push cover the same rows."""
    rng = np.random.RandomState(int(spec["seed"]))
    n = int(spec.get("batch", 8))
    s = int(spec.get("slots", 4))
    vocab = int(spec["vocab"])
    return rng.randint(0, vocab, size=(n, s)).astype(np.int64).reshape(-1)
