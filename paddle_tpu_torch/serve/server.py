"""Serving reliability layer: the scheduler around DecodeEngine (port
of `paddle_tpu.serve.server`; the scheduling is host-side and the same
as the JAX package's, the engine under it is the port's).

`DecodeEngine.serve()` assumes a benevolent world: every request is
well-formed, every caller waits forever, and the engine never faults.
Under the ROADMAP's "heavy traffic from millions of users" none of
that holds, and TPU LLM serving work (Ragged Paged Attention,
arXiv:2604.15464) locates the availability bottleneck in the request
scheduler, not the kernel. `ServingServer` is that scheduler — the
serving counterpart of `train.resilience.ResilientTrainer`, with the
same prove-it-with-fault-injection discipline (`testing.faults`
serving plan, `tests/test_serve_server.py`):

- **Bounded admission queue with load shedding.** `submit()` is the
  explicit-backpressure boundary: malformed requests (garbage/
  oversized prompts, bad max_new, a prompt whose own blocks exceed
  the whole page pool) are rejected synchronously with `ValueError`
  and never enter the queue; when the queue is full the
  CHEAPEST-TO-RETRY request (fewest prompt tokens to re-prefill, then
  most deadline slack, then newest) is shed — dropping the incoming
  request raises `QueueFullError`, displacing a queued one records it
  shed and admits the newcomer. Every shed carries the documented
  "load shed" error text.
- **Page-pool-aware admission.** Over a paged engine the binding
  resource is PAGES, not slots: `_admit` consults the pool's
  `headroom()` (free + reclaimable-from-prefix-cache) against the
  request's post-prefix-reuse page need and defers admission while
  in-flight work frees pages. Mid-decode exhaustion (an
  over-subscribed pool where everyone ran long) preempts the
  cheapest co-tenant back onto the queue (one retry-budget unit, the
  standard recompute preemption) or — with nobody to evict — retires
  the needy request at pool capacity; prefill-time
  `PoolExhaustedError` rides the ordinary requeue path. Pool
  exhaustion is therefore a first-class shed/requeue reason
  (docs/RELIABILITY.md "Serving fault model").
- **Chunked-prefill interleave.** When the engine was built with
  `prefill_chunk`, admission takes a `PrefillTicket` and the drive
  loop advances ONE chunk per pending slot per iteration between
  decode steps — a long prompt cannot head-of-line-stall active
  decodes. Deadlines, drain, retry, and eviction treat a mid-prefill
  slot exactly like a decoding one.
- **Per-request deadlines, enforced mid-generation.** A deadline is
  fixed at submit time; the host loop checks it at every step
  boundary, so an expired request frees its slot for queued work
  instead of finishing dead tokens, and a request that expires while
  still queued never costs a prefill at all. Partial tokens are kept
  in the result (outcome "expired").
- **Slot-level retry/requeue.** A transient fault (FaultError, native
  bridge error, any non-ValueError) during prefill requeues THAT
  request at the queue front; during a decode step it requeues every
  in-flight request — prefill/decode are pure functions of the state,
  so the held state is never half-mutated and retry is exact. Each
  requeue spends one unit of the request's retry budget; an exhausted
  budget ends the request "failed". ValueError is deterministic
  rejection, never retried.
- **Graceful drain.** `drain()` (or SIGTERM/SIGINT with
  `install_signal_handlers=True`, mirroring `train/resilience.py`'s
  drain-at-the-next-boundary semantics) stops admission, sheds the
  queue, finishes in-flight requests within `drain_grace_s`, expires
  whatever is still running past the grace, and persists a drain
  report (counters + per-request outcomes) to `drain_report_path`.
- **Circuit breaker over a second backend.** When a `native_backend`
  engine (an explicit second backend object) is supplied, pool work
  runs through it until `CircuitBreaker` sees
  `failure_threshold` consecutive faults — then the server falls back
  to the primary `engine` and keeps serving; after `cooldown_s` the
  breaker half-opens and the next empty-pool moment probes the native
  side again (closed on success, re-opened on failure).

Accounting contract (the chaos test's reconciliation invariant): every
submitted request ends in EXACTLY ONE of completed / expired / shed /
failed, `stats` counters equal the tally over `results`, and the pool
keeps serving after any mix of the above.

Serving artifacts: `artifact_path` names an engine bundle
(`serve.artifact.save_engine_artifact`); the replica verifies its
manifest against the engine and the server's buckets at boot and serves
through its programs. Any failure -- a mismatch, a missing or corrupt
file -- keeps the eager path, counted in `artifact_fallbacks` with an
"artifact"/"fallback" flight event: never a failed boot, never a wrong
answer.

Port notes: `RequestResult.backend` and the drain report name the
primary engine "torch" where the JAX package says "jax"; a step reads
its outputs back in one host copy.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.obs.flight import FlightRecorder
from paddle_tpu_torch.obs.trace import Tracer
from paddle_tpu_torch.serve.engine import PoolStats, pad_to_bucket
from paddle_tpu_torch.serve.paged import PoolExhaustedError, blocks_for
from paddle_tpu_torch.serve.policy import SchedulerPolicy
from paddle_tpu_torch.serve.shm_arena import ArenaError, attach_cached
from paddle_tpu_torch.serve.speculative import NGramProposer

log = logging.getLogger(__name__)

#: page-pool counter keys accumulated across pool generations
#: (backend switches / decode-fault resets build a fresh PagePool)
_POOL_COUNTER_KEYS = ("prefix_hits", "prefix_misses",
                      "prefix_rejected", "prefill_chunks",
                      "spec_reserved", "spec_rolled_back",
                      "migrated_out_pages", "migrated_in_pages")

def _flatten_kv(kv):
    """Flatten an exported KV payload (per-layer tuples whose
    elements are ndarrays OR `(data, scale)` ndarray tuples — the
    int8 shape) into a flat list of contiguous buffers plus the spec
    that rebuilds the nesting. The data plane moves BUFFERS; the
    control frame carries the spec."""
    arrays, spec = [], []
    for layer in kv:
        lspec = []
        for p in layer:
            if isinstance(p, tuple):
                sub = []
                for q in p:
                    a = np.ascontiguousarray(np.asarray(q))
                    arrays.append(a)
                    sub.append((a.dtype.str, a.shape))
                lspec.append(("t", sub))
            else:
                a = np.ascontiguousarray(np.asarray(p))
                arrays.append(a)
                lspec.append(("a", (a.dtype.str, a.shape)))
        spec.append(lspec)
    return arrays, spec


def _unflatten_kv(bufs, spec):
    """Rebuild the KV nesting from gathered buffers — zero-copy views
    over the arena where the buffer wasn't segment-spanning."""
    it = iter(bufs)

    def mk(ds):
        dtype, shape = ds
        return np.frombuffer(next(it), dtype=np.dtype(dtype)) \
            .reshape(shape)

    return [tuple(tuple(mk(d) for d in ds) if kind == "t" else mk(ds)
                  for kind, ds in lspec)
            for lspec in spec]


#: terminal request outcomes — exactly one per submitted request
COMPLETED = "completed"
EXPIRED = "expired"
SHED = "shed"
FAILED = "failed"
OUTCOMES = (COMPLETED, EXPIRED, SHED, FAILED)


class QueueFullError(RuntimeError):
    """The admission queue is full and the INCOMING request was the
    cheapest to retry — the explicit-backpressure signal. The request
    is recorded shed; the caller should back off and resubmit."""


class MigrationRefusedError(RuntimeError):
    """A decode-tier replica declined `import_request` TRANSIENTLY —
    no free slot, page pool too full to map the migrated blocks, or
    the server is draining. Nothing changed on either side: the
    source's export pins are intact, so the orchestrator picks
    another destination or retries later. Contrast ValueError from
    import_request (geometry mismatch), which is deterministic and
    means the fleet is mis-wired."""


def _host_copy(*outs):
    """One host copy of a step's device outputs ([S] or [S, K] rows of
    tokens, logprobs, flags and counts): the rows are concatenated as
    float64 (exact for token ids and f32 logprobs), moved once, and
    split back into numpy arrays of each output's kind."""
    cols = [o.reshape(o.shape[0], -1).double() for o in outs]
    host = torch.cat(cols, dim=1).cpu().numpy()
    res, at = [], 0
    for o, c in zip(outs, cols):
        part = host[:, at:at + c.shape[1]].reshape(tuple(o.shape))
        at += c.shape[1]
        if o.dtype == torch.bool:
            part = part.astype(bool)
        elif not o.is_floating_point():
            part = part.astype(np.int64)
        else:
            part = part.astype(np.float32)
        res.append(part)
    return tuple(res)


def _replica_fatal(exc: Exception) -> bool:
    """True for errors that mean the BACKEND IS GONE (a dead replica's
    engine raising `serve.router.ReplicaDeadError`), not a transient
    fault: the server must NOT burn the in-flight requests' retry
    budgets against a corpse — it re-raises so the fleet router can
    mark the replica dead and redistribute with budgets intact. Duck-
    typed on a `replica_fatal` attribute so this module needs no
    import of the router (which imports it)."""
    return bool(getattr(exc, "replica_fatal", False))


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed -> open ->
    half-open -> closed). `allow()` gates calls: closed and half-open
    permit them, open refuses until `cooldown_s` has passed on the
    injected clock (then half-open: ONE probe decides — success closes,
    failure re-opens for another cooldown). `trips` counts
    closed->open transitions for observability."""

    def __init__(self, *, failure_threshold: int = 3,
                 cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got "
                             f"{failure_threshold}")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.failures = 0
        self.trips = 0
        self._opened_at: Optional[float] = None
        self._half_open = False

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return "closed"
        if (self._half_open
                or self.clock() - self._opened_at >= self.cooldown_s):
            return "half-open"
        return "open"

    def allow(self) -> bool:
        st = self.state
        if st == "half-open":
            self._half_open = True   # sticky until the probe resolves
        return st != "open"

    def record_success(self) -> None:
        self.failures = 0
        self._opened_at = None
        self._half_open = False

    def record_failure(self) -> None:
        self.failures += 1
        if self._half_open or (self._opened_at is None
                               and self.failures >= self.failure_threshold):
            if self._opened_at is None:
                self.trips += 1
            self._opened_at = self.clock()
            self._half_open = False


@dataclasses.dataclass
class Request:
    """One admitted unit of work. `deadline` is ABSOLUTE on the
    server's clock (None = wait forever); `retries_left` is the
    remaining transient-fault budget."""

    req_id: int
    prompt: np.ndarray
    true_len: int
    max_new: int
    sampling: Optional[dict]
    deadline: Optional[float]
    submitted_at: float
    retries_left: int

    @property
    def retry_cost(self) -> tuple:
        """Shed-victim ordering: CHEAPEST first. Cheapest to retry =
        least prefill work to redo (prompt tokens), then the most
        deadline slack left (an unconstrained request can always wait),
        then the newest arrival (least queue time invested)."""
        slack = -(self.deadline if self.deadline is not None
                  else float("inf"))
        return (self.true_len, slack, -self.req_id)


@dataclasses.dataclass
class RequestResult:
    """Terminal record for one submitted request. `tokens` holds
    whatever was generated before the outcome landed (the full
    completion for COMPLETED, a partial prefix for EXPIRED, empty
    otherwise); `error` is the human-readable reason for every
    non-completed outcome; `backend` names which engine served it."""

    req_id: int
    outcome: str
    tokens: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    retries: int = 0
    backend: Optional[str] = None
    submitted_at: float = 0.0
    done_at: float = 0.0


class ServingServer:
    """Reliability scheduler over one (or two: native + fallback)
    DecodeEngine-compatible backends. Drive it synchronously:
    `submit()` traffic, then `run()` until the queue and pool drain;
    `on_step` hooks (called after every decode step with
    `(server, step_index)`) let tests and operators inject mid-run
    events — more traffic, `drain()`, clock advances."""

    def __init__(self, engine, *, max_queue: int = 64,
                 default_deadline_ms: Optional[float] = None,
                 max_retries: int = 1,
                 buckets: Optional[tuple] = None,
                 drain_grace_s: float = 30.0,
                 native_backend=None,
                 breaker: Optional[CircuitBreaker] = None,
                 clock: Callable[[], float] = time.monotonic,
                 drain_report_path: Optional[str] = None,
                 install_signal_handlers: bool = False,
                 policy: Optional[SchedulerPolicy] = None,
                 tracer: Optional[Tracer] = None,
                 flight: Optional[FlightRecorder] = None,
                 speculative: bool = False,
                 proposer=None,
                 artifact_path: Optional[str] = None,
                 role: str = "unified",
                 data_plane=None):
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"role must be 'unified', 'prefill' or 'decode', "
                f"got {role!r}")
        if role != "unified":
            # disaggregation moves paged KV blocks between replicas:
            # both tiers need the paged engine's migration
            # surface (pause/export/import/resume)
            if not getattr(engine, "paged", False):
                raise ValueError(
                    f"role={role!r} needs a paged engine "
                    f"(KV-block migration)")
            if native_backend is not None:
                raise ValueError(
                    "disaggregated roles run the paged engine only "
                    "(no native fallback pair)")
        self.role = role
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{max_retries}")
        if buckets is not None and engine.cfg.attn_window is None:
            too_big = [b for b in buckets if b > engine.max_len]
            if too_big:
                raise ValueError(
                    f"buckets {too_big} exceed max_len "
                    f"{engine.max_len}: padded prefills cannot fit "
                    f"the cache")
        if speculative:
            if engine.cfg.attn_window is not None:
                raise ValueError(
                    "speculative serving needs the paged engine "
                    "(sliding-window configs decode plain)")
            if getattr(engine, "select_fn", None) is not None:
                raise ValueError(
                    "speculative serving composes with per-request "
                    "sampling only: a pool-wide select_fn overrides "
                    "the distribution the acceptance rule preserves")
        self.speculative = speculative
        self.proposer = (proposer if proposer is not None
                         else NGramProposer() if speculative else None)
        self.engine = engine              # the primary (fallback) engine
        self.native_backend = native_backend
        # scheduling DECISIONS route through the policy surface
        # (serve.policy): default to the engine's own policy so one
        # object governs both schedulers, else the stock FIFO policy
        self.policy = (policy if policy is not None
                       else getattr(engine, "policy", None)
                       or SchedulerPolicy())
        self.max_queue = max_queue
        self.default_deadline_ms = default_deadline_ms
        self.max_retries = max_retries
        self.buckets = tuple(sorted(buckets)) if buckets else None
        self.drain_grace_s = drain_grace_s
        self.clock = clock
        self.drain_report_path = drain_report_path
        self.breaker = breaker or (CircuitBreaker(clock=clock)
                                   if native_backend is not None
                                   else None)
        self.install_signal_handlers = install_signal_handlers
        self.on_step: List[Callable] = []
        # observability (paddle_tpu_torch.obs): pure host-side — spans
        # and flight events never touch a device value. Both default
        # OFF (None).
        self.tracer = tracer
        self.flight = flight
        # req_id -> live Span (cached so per-event instrumentation
        # skips the tracer's lock; the id lives on span.trace_id)
        self._trace_ids: Dict[int, Any] = {}
        self._admitting_req: Optional[Request] = None
        self._latency_hist = None
        self._latency_labels: Dict[str, str] = {}

        self.stats = PoolStats()
        self.results: Dict[int, RequestResult] = {}
        self.queue: List[Request] = []
        self._next_id = 0
        self._draining = False
        self._drain_deadline: Optional[float] = None
        self._drain_reason: Optional[str] = None
        # set by the signal handler, consumed at the top of step():
        # the handler itself must not log, dump, or drain (LK005)
        self._pending_signal: Optional[int] = None
        self.drain_report: Optional[dict] = None

        # serving artifacts (serve.artifact): a replica boots from the
        # bundle when its manifest verifies against THIS engine; any
        # mismatch keeps the eager path, counted and flight-recorded
        self.artifact_path = artifact_path
        if self.flight is not None and hasattr(engine,
                                               "_artifact_hook"):
            engine._artifact_hook = (
                lambda member, err: self.flight.record(
                    "artifact", "fallback", member=member, error=err))
        if artifact_path:
            self._load_artifact(artifact_path)

        # active backend + its device pool (rebuilt on backend switch)
        self._backend = (native_backend if native_backend is not None
                         else engine)
        self._state = None
        self._slot_req: List[Optional[Request]] = []
        self._emitted: Dict[int, List[int]] = {}
        self._lps: Dict[int, List[float]] = {}
        # chunked-prefill tickets per slot (engines built with
        # prefill_chunk): advanced one chunk per drive-loop iteration
        self._prefilling: Dict[int, object] = {}
        # page-pool counters survive pool generations (reset/switch)
        self._active_pool = None
        self._pool_base: Dict[str, int] = {
            k: 0 for k in _POOL_COUNTER_KEYS}
        self._pool_base["peak_pages_in_use"] = 0
        # disaggregation handoff state: req_id -> {slot, seed,
        # export_id, pages} for prefill-complete requests parked for
        # migration (role="prefill" parks every finished prefill; the
        # router exports/ACKs them). Server-level migration counters
        # are separate from the pool's page counters.
        self._handoff: Dict[int, dict] = {}
        self.migrated_in = 0
        self.migrated_out = 0
        self.handoffs_cancelled = 0

        # zero-copy data plane (serve.shm_arena): exported KV pages
        # scatter into the shared arena and the control frame carries
        # only the ticket. `data_plane` is a ShmArena, an arena NAME
        # to attach (the fleet injects the supervisor's arena into
        # spawned replicas this way), or None (inline pickle path).
        # EVERY data-plane failure — attach here, scatter/gather
        # later — degrades to the inline path with a counter + flight
        # event: never a wrong answer, never a failed boot.
        self.data_plane_fallbacks = 0
        if isinstance(data_plane, str):
            try:
                data_plane = attach_cached(data_plane)
            except ArenaError as e:
                self._data_plane_fallback("attach", repr(e))
                data_plane = None
        self.data_plane = data_plane

    def _data_plane_fallback(self, where: str, error: str) -> None:
        self.data_plane_fallbacks += 1
        if self.flight is not None:
            self.flight.record("data_plane", "fallback", where=where,
                               error=error)

    def _load_artifact(self, path: str) -> None:
        """Boot-time artifact adoption: verify the bundle's manifest
        against the engine and bind its programs; ANY failure --
        mismatch, missing file, corrupt tar -- keeps the eager path
        with the fallback counter and a flight event as evidence."""
        from paddle_tpu_torch.serve.artifact import load_engine_artifact
        try:
            programs, manifest = load_engine_artifact(
                self.engine, path, expect_buckets=self.buckets)
            self.engine.bind_artifact(programs, manifest)
        except Exception as e:
            self.engine.artifact_fallback("load", repr(e))

    @property
    def draining(self) -> bool:
        """True once drain() (or a handled SIGTERM/SIGINT) stopped
        admission — feeders should stop submitting."""
        return self._draining

    @property
    def queue_space(self) -> int:
        """Free admission-queue capacity right now — a well-behaved
        batch client submits at most this many before the next run()/
        step instead of forcing the shed path."""
        return max(self.max_queue - len(self.queue), 0)

    # -- admission ---------------------------------------------------------

    def _validate(self, prompt, max_new: int) -> np.ndarray:
        cfg = self.engine.cfg
        arr = np.asarray(prompt)
        if arr.ndim != 1:
            raise ValueError(
                f"prompt must be 1-D token ids, got shape "
                f"{arr.shape}")
        if arr.size < 1:
            raise ValueError("prompt is empty (need >= 1 token)")
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(
                f"prompt must be integer token ids, got dtype "
                f"{arr.dtype}")
        if arr.min() < 0 or arr.max() >= cfg.vocab:
            raise ValueError(
                f"prompt ids must be in [0, {cfg.vocab}), got range "
                f"[{arr.min()}, {arr.max()}]")
        t0 = int(arr.size)
        if self.buckets is not None and t0 > self.buckets[-1]:
            raise ValueError(
                f"prompt len {t0} exceeds largest bucket "
                f"{self.buckets[-1]}")
        if cfg.attn_window is None and t0 >= self.engine.max_len:
            raise ValueError(
                f"prompt len {t0} >= max_len {self.engine.max_len}: "
                f"no room for a generated token")
        if cfg.attn_window is None and getattr(self.engine, "paged",
                                               False):
            # page-granular capacity (engine.prefill_begin's rule): a
            # prompt that fits max_len but not the WHOLE page pool can
            # never be served — reject at submit, not mid-prefill
            need = blocks_for(t0, self.engine.page_size)
            if need > self.engine.num_pages:
                raise ValueError(
                    f"prompt len {t0} needs {need} pages > page pool "
                    f"num_pages {self.engine.num_pages}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        return arr.astype(np.int32)

    def _finish(self, req: Request, outcome: str, *,
                error: Optional[str] = None,
                retries: int = 0) -> RequestResult:
        res = RequestResult(
            req_id=req.req_id, outcome=outcome,
            tokens=list(self._emitted.pop(req.req_id, [])),
            logprobs=list(self._lps.pop(req.req_id, [])),
            error=error, retries=retries,
            backend=self._backend_name(),
            submitted_at=req.submitted_at, done_at=self.clock())
        self.results[req.req_id] = res
        setattr(self.stats, outcome, getattr(self.stats, outcome) + 1)
        self._trace_end(req.req_id, outcome, error=error,
                        retries=retries, backend=res.backend,
                        tokens=len(res.tokens))
        if self._latency_hist is not None:
            self._latency_hist.observe(
                res.done_at - res.submitted_at,
                labels={**self._latency_labels, "outcome": outcome})
        return res

    def _backend_name(self) -> str:
        return ("native" if self._backend is not None
                and self._backend is self.native_backend else "torch")

    # -- observability plumbing (host-side only) ---------------------------

    def _trace_event(self, req_id: int, name: str, **data) -> None:
        if self.tracer is None:
            return
        span = self._trace_ids.get(req_id)
        if span is not None:
            # the cached span skips the tracer's lock + live-table
            # lookup — this runs per admit/retry on the serve loop
            span.event(name, **data)

    def _trace_end(self, req_id: int, outcome: str, **tags) -> None:
        if self.tracer is None:
            return
        span = self._trace_ids.pop(req_id, None)
        if span is not None:
            self.tracer.end(span, outcome, **tags)

    def _flight_dump(self, reason: str, **extra) -> None:
        """Dump the flight ring next to the drain report (the
        postmortem directory). Without a drain_report_path the ring
        stays in memory — the event is still recorded."""
        if self.flight is None or not self.drain_report_path:
            return
        d = os.path.dirname(self.drain_report_path) or "."
        self.flight.dump(d, reason,
                         extra={**extra, "counters": self.counters()})

    def _pool_obs(self, event: str, ctx: dict) -> None:
        """PagePool admit/release seam (`pool.obs_hook`): attach page
        events to the owning request's span via the host ledger and
        mirror them into the flight ring. During prefill the slot is
        not yet in `_slot_req` — `_admitting_req` bridges the gap."""
        slot = ctx.get("slot")
        req = (self._slot_req[slot]
               if slot is not None
               and 0 <= slot < len(self._slot_req) else None)
        if req is None:
            req = self._admitting_req
        if req is not None:
            self._trace_event(req.req_id, event, **ctx)
            if self.tracer is not None:
                return  # the span carries the event into the ring via
                        # the sink — a separate flight record would
                        # double the per-admission cost for no signal
        if self.flight is not None:
            self.flight.record("pool", event, **ctx)

    def bind_metrics(self, registry, *, prefix: str = "serve",
                     labels: Optional[Dict[str, str]] = None) -> None:
        """Attach this server to a `obs.MetricsRegistry`: the ledger
        (`counters()`) becomes a read-through source — exported
        metrics and `reconcile()` read the SAME numbers — and a
        request-latency histogram is observed at every terminal
        outcome. `labels` (e.g. {"replica": "r0"}) keeps multiple
        servers on one registry apart."""
        self._latency_labels = dict(labels or {})
        registry.register_source(prefix, self.counters, labels=labels)
        self._latency_hist = registry.histogram(
            f"{prefix}_request_latency_seconds",
            "submit -> terminal-outcome latency, by outcome")
        if self.tracer is not None:
            registry.register_source(f"{prefix}_trace",
                                     self.tracer.counters,
                                     labels=labels)
        if self.flight is not None:
            registry.register_source(f"{prefix}_flight",
                                     self.flight.counters,
                                     labels=labels)

    def submit(self, prompt, *, max_new: int,
               deadline_ms: Optional[float] = -1,
               sampling: Optional[dict] = None,
               retries_left: Optional[int] = None,
               trace_id: Optional[str] = None) -> int:
        """Enqueue one request; returns its req_id. `deadline_ms` is
        relative to now (-1 = the server default, None = no deadline).
        `retries_left` overrides the transient-fault budget for THIS
        request (default: the server's `max_retries`) — the fleet
        router uses it to redistribute a dead replica's requests onto
        survivors with their remaining budgets intact.

        Raises ValueError for malformed input (recorded FAILED — it
        never enters the queue) and QueueFullError when the queue is
        full and the incoming request is the shed victim (recorded
        SHED). Both are also visible in `results`, so burst callers
        can reconcile without catching."""
        req_id = self._next_id
        self._next_id += 1
        self.stats.requests += 1
        now = self.clock()
        if self.tracer is not None:
            # mint once: the fleet router passes its rr id down so a
            # redistributed request keeps ONE span; a standalone
            # server mints req<N>. Tracer.start dedupes a live id
            # (resubmission after replica death) instead of forking
            # the audit trail.
            tid = trace_id if trace_id is not None else f"req{req_id}"
            self._trace_ids[req_id] = self.tracer.start(
                tid, "serve.request", req_id=req_id)
        try:
            arr = self._validate(prompt, max_new)
        except ValueError as e:
            self.results[req_id] = RequestResult(
                req_id=req_id, outcome=FAILED, error=str(e),
                submitted_at=now, done_at=now)
            self.stats.failed += 1
            self._trace_end(req_id, FAILED, error=str(e))
            e.req_id = req_id       # burst callers reconcile by id
            raise
        if deadline_ms == -1:
            deadline_ms = self.default_deadline_ms
        deadline = (None if deadline_ms is None
                    else now + float(deadline_ms) / 1000.0)
        req = Request(req_id=req_id, prompt=arr, true_len=int(arr.size),
                      max_new=max_new, sampling=sampling,
                      deadline=deadline, submitted_at=now,
                      retries_left=(self.max_retries
                                    if retries_left is None
                                    else retries_left))
        if self._draining:
            self._finish(req, SHED,
                         error="load shed: server is draining")
            err = QueueFullError(
                f"request {req_id} shed: server is draining")
            err.req_id = req_id
            raise err
        if len(self.queue) >= self.max_queue:
            victim = self.policy.shed_victim(self.queue, req)
            if victim is req:
                self._finish(req, SHED, error=(
                    f"load shed: queue full (max_queue="
                    f"{self.max_queue}), request is cheapest to retry"))
                err = QueueFullError(
                    f"request {req_id} shed: queue full "
                    f"(max_queue={self.max_queue})")
                err.req_id = req_id
                raise err
            self.queue.remove(victim)
            self._finish(victim, SHED, error=(
                f"load shed: queue full (max_queue={self.max_queue}), "
                f"displaced as cheapest to retry"))
        self.queue.append(req)
        return req_id

    def withdraw_queued(self, req_id: int) -> Optional[Request]:
        """Remove a QUEUED request as if it had never been submitted:
        it leaves the queue and the submission counter backs it out,
        so this server's ledger stays balanced (len(results) ==
        stats.requests) with no terminal outcome recorded here. The
        fleet router's retire path uses this to hand a retiring
        replica's queue to survivors; returns None when `req_id` is
        not queued (already admitted, finished, or unknown)."""
        for req in self.queue:
            if req.req_id == req_id:
                self.queue.remove(req)
                self.stats.requests -= 1
                return req
        return None

    def cancel(self, req_id: int, *,
               reason: str = "client cancelled") -> bool:
        """Force-expire one request NOW — the network edge's
        client-disconnect path (docs/RELIABILITY.md "Network-edge
        fault model"). The request's deadline is pulled to the
        current clock, so the next `step()`'s PROVEN expiry machinery
        (`_expire_queued` / `_expire_in_flight` → `_retire_slot`)
        frees the slot, its pages, and any parked handoff pins with
        exactly the cleanup a naturally-lapsed deadline gets: one
        terminal outcome (EXPIRED), ledgers balanced, `reconcile()`
        clean. Idempotent — returns False when `req_id` is already
        terminal or unknown."""
        now = self.clock()
        for req in list(self.queue) + [r for r in self._slot_req
                                       if r is not None]:
            if req.req_id == req_id:
                req.deadline = now
                self._trace_event(req_id, "cancel", reason=reason)
                return True
        return False

    def partial_tokens(self, req_id: int) -> List[int]:
        """Snapshot of the tokens emitted SO FAR for one request —
        the streaming read the HTTP edge polls between steps. A live
        request answers from the decode-step accumulation buffer
        (copied, never aliasing scheduler state); a terminal one
        answers from its result's final token list, so a poller that
        follows a request through completion sees one monotone
        prefix chain with no gap between "decoding" and "done"."""
        res = self.results.get(req_id)
        if res is not None:
            return list(res.tokens)
        return list(self._emitted.get(req_id, []))

    # -- disaggregated prefill/decode handoff ------------------------------
    #
    # The migration protocol (docs/SERVING.md "Disaggregated
    # prefill/decode"): a role="prefill" replica parks every finished
    # prefill (pause_slot + an export pin on its pages) instead of
    # decoding it; the fleet router harvests `ready_handoffs()`, pulls
    # the transferable payload with `export_request()`, feeds it to a
    # decode-tier replica's `import_request()`, and ACKs with
    # `handoff_complete()` — which releases the source copy and backs
    # the request out of this server's ledger (withdraw_queued
    # semantics: the request's ONE terminal outcome lands on the
    # destination). Until that ACK the source pages stay pinned, so a
    # destination dying mid-transfer costs nothing: the router retries
    # another destination or falls back to `cancel_handoff()` (decode
    # locally — graceful degrade, never a lost request).

    def _park_for_handoff(self, slot: int) -> None:
        req = self._slot_req[slot]
        self._state, seed = self.engine.pause_slot(self._state, slot)
        eid, pages = self._active_pool.export_blocks(slot)
        self._handoff[req.req_id] = {
            "slot": slot, "seed": seed, "export_id": eid,
            "pages": pages}
        self._trace_event(req.req_id, "handoff_ready", slot=slot,
                          pages=len(pages))

    def ready_handoffs(self) -> List[int]:
        """req_ids parked at prefill-complete, awaiting migration —
        the router's harvest surface (host-side, no device sync)."""
        return list(self._handoff)

    def export_request(self, req_id: int) -> dict:
        """The transferable migration payload for one parked request:
        scheduling identity (prompt/sampling/budgets, deadline as
        REMAINING milliseconds — absolute clocks don't cross
        replicas), the DecodeSeed, the raw arena contents of its
        pages, and the source geometry for the destination's import
        gate. Reads the device; the export pin guarantees the pages
        are still whole even if the slot was retired meanwhile."""
        h = self._handoff[req_id]
        req = self._slot_req[h["slot"]]
        assert req is not None and req.req_id == req_id, (
            req_id, h["slot"])
        remaining_ms = (
            None if req.deadline is None
            else max(0.0, (req.deadline - self.clock()) * 1000.0))
        span = self._trace_ids.get(req_id)
        self._trace_event(req_id, "handoff_export",
                          pages=len(h["pages"]))
        payload = {
            "prompt": req.prompt,
            "true_len": req.true_len,
            "max_new": req.max_new,
            "sampling": req.sampling,
            "retries_left": req.retries_left,
            "remaining_ms": remaining_ms,
            "seed": h["seed"],
            "kv": None,
            "n_pages": len(h["pages"]),
            "geometry": self.engine.kv_geometry(),
            "trace_id": getattr(span, "trace_id", None),
        }
        if self.data_plane is not None:
            try:
                if "ticket" not in h:
                    # first export: scatter the page bytes into the
                    # arena ONCE and park the ticket on the handoff —
                    # an RPC retry (or a retargeted destination after
                    # a dst death) re-exports the SAME ticket instead
                    # of leaking a second scatter
                    arrays, spec = _flatten_kv(
                        self.engine.export_slot_kv(self._state,
                                                   h["pages"]))
                    h["ticket"] = self.data_plane.scatter(arrays)
                    h["kv_spec"] = spec
                payload["kv_ref"] = {"ticket": h["ticket"],
                                     "spec": h["kv_spec"]}
                return payload
            except ArenaError as e:
                # size cap / arena gone: inline pickle path below —
                # slower, never a wrong answer
                self._data_plane_fallback("scatter", repr(e))
        payload["kv"] = self.engine.export_slot_kv(self._state,
                                                   h["pages"])
        return payload

    def handoff_complete(self, req_id: int) -> None:
        """Destination ACK: release the source copy (export pin +
        slot pages) and back the request out of this ledger with NO
        terminal outcome here — the destination now owns it, and the
        fleet-wide 'requests' sum keeps counting each request once.
        `prefills` and the migration counters keep the work visible."""
        h = self._handoff.pop(req_id)
        slot = h["slot"]
        self._active_pool.release_export(h["export_id"])
        self._free_ticket(h)
        self._retire_slot(slot)
        self._emitted.pop(req_id, None)
        self._lps.pop(req_id, None)
        self.stats.requests -= 1
        self.stats.admitted -= 1
        self.migrated_out += 1
        self._trace_event(req_id, "migrated_out", pages=len(h["pages"]))
        # the span itself lives on: the destination's tracer.start
        # dedupes the live trace_id, so ONE span follows the request
        self._trace_ids.pop(req_id, None)

    def cancel_handoff(self, req_id: int) -> None:
        """Abandon a parked migration and decode the request HERE —
        the graceful degrade when no decode-tier replica can take it.
        Resumes the paused row bit-exactly; the slot then rides the
        ordinary decode path on this server."""
        h = self._handoff.pop(req_id)
        self._active_pool.release_export(h["export_id"])
        self._free_ticket(h)
        self._state = self.engine.resume_slot(
            self._state, h["slot"], h["seed"])
        self.handoffs_cancelled += 1
        self._trace_event(req_id, "handoff_cancelled", slot=h["slot"])

    def _free_ticket(self, h: dict) -> None:
        """Release a handoff's arena segments with its export pin —
        the pins-release-on-ACK contract extended to the data plane.
        Idempotent like the pin release (the arena skips segments
        already freed or reowned)."""
        ticket = h.pop("ticket", None)
        if ticket is not None and self.data_plane is not None:
            self.data_plane.free(ticket)

    def import_request(self, payload: dict) -> int:
        """Decode-tier intake for a migrated finished prefill. Gates
        first (geometry must match — ValueError, mis-wired fleet;
        capacity must exist RIGHT NOW — MigrationRefusedError,
        transient, nothing changed), then maps pages
        (`pool.import_blocks`: cached leading blocks under the same
        chain_keys derivation are shared, the inbound copy of those
        is skipped), writes the arena contents, resumes the row from
        the DecodeSeed, and registers the full blocks so the migrated
        prefix SEEDS this pool's cache. The ledger commits LAST: a
        replica-fatal fault mid-import leaves this server never
        having known the request (the source still holds it parked),
        so exactly-once needs no distributed transaction. Returns the
        destination req_id."""
        if payload["geometry"] != self.engine.kv_geometry():
            raise ValueError(
                f"migration geometry mismatch: source "
                f"{payload['geometry']} vs destination "
                f"{self.engine.kv_geometry()}")
        if self._draining:
            raise MigrationRefusedError(
                "import refused: server is draining")
        if self._state is None:
            self._reset_pool()
        pool = self._active_pool
        try:
            slot = self._slot_req.index(None)
        except ValueError:
            raise MigrationRefusedError(
                "import refused: no free slot") from None
        prompt = np.asarray(payload["prompt"], np.int32)
        true_len = int(payload["true_len"])
        if not pool.admissible(prompt, true_len):
            raise MigrationRefusedError(
                "import refused: page pool cannot map the migrated "
                "blocks right now")
        kv = payload.get("kv")
        adopt = None
        if kv is None:
            # zero-copy arm: the frame carried a ticket, the bytes
            # are in the shared arena. ANY gather failure (arena
            # unattachable, ticket gone stale under an orphan
            # reclaim) refuses the migration — transient from the
            # router's view (the source copy is still pinned), so it
            # retargets or cancels; never a wrong answer.
            ref = payload["kv_ref"]
            try:
                arena = (self.data_plane
                         if self.data_plane is not None
                         and self.data_plane.name
                         == ref["ticket"]["arena"]
                         else attach_cached(ref["ticket"]["arena"]))
                kv = _unflatten_kv(arena.gather(ref["ticket"]),
                                   ref["spec"])
            except ArenaError as e:
                self._data_plane_fallback("gather", repr(e))
                raise MigrationRefusedError(
                    f"import refused: data-plane gather failed: "
                    f"{e}") from e
            adopt = (arena, ref["ticket"])
        try:
            pages, shared_blocks = pool.import_blocks(
                slot, prompt, true_len)
        except PoolExhaustedError as e:
            raise MigrationRefusedError(
                f"import refused: {e}") from None
        try:
            self._state = self.engine.import_slot_kv(
                self._state, slot, pages, shared_blocks, kv)
            self._state = self.engine.resume_slot(
                self._state, slot, payload["seed"])
        except Exception:
            # the engine died (or faulted) mid-import: balance the
            # HOST books (release the slot's page refs — host-side,
            # works over a dead device) and let the error propagate;
            # the source copy is still pinned, the router redirects
            pool.release(slot)
            raise
        pool.register(slot, prompt, true_len)
        req_id = self._next_id
        self._next_id += 1
        self.stats.requests += 1
        self.stats.admitted += 1
        self.migrated_in += 1
        now = self.clock()
        rem = payload.get("remaining_ms")
        req = Request(
            req_id=req_id, prompt=prompt, true_len=true_len,
            max_new=int(payload["max_new"]),
            sampling=payload.get("sampling"),
            deadline=(None if rem is None
                      else now + float(rem) / 1000.0),
            submitted_at=now,
            retries_left=int(payload.get("retries_left",
                                         self.max_retries)))
        self._slot_req[slot] = req
        self._emitted[req_id] = []
        self._lps[req_id] = []
        if self.tracer is not None:
            tid = payload.get("trace_id") or f"req{req_id}"
            self._trace_ids[req_id] = self.tracer.start(
                tid, "serve.request", req_id=req_id)
            self._trace_event(req_id, "migrated_in", slot=slot,
                              pages=len(pages),
                              shared_blocks=shared_blocks)
        if adopt is not None:
            # stamp the adoption LAST: the bytes are already copied
            # into this pool, so the stamp is pure ledger evidence
            # ('delivered' vs 'died unread' for the orphan sweep).
            # A stale ticket here (source died + reclaimed between
            # gather and now) must not un-admit the request — the
            # import committed; record the miss and move on.
            arena, ticket = adopt
            try:
                arena.adopt(ticket)
            except ArenaError as e:
                self._data_plane_fallback("adopt", repr(e))
        return req_id

    # -- drain -------------------------------------------------------------

    def drain(self, *, grace_s: Optional[float] = None,
              reason: str = "drain requested") -> None:
        """Stop admitting; `run()` finishes in-flight work within the
        grace, sheds the queue, and persists the drain report."""
        if not self._draining:
            self._draining = True
            self._drain_reason = reason
            self._drain_deadline = self.clock() + (
                self.drain_grace_s if grace_s is None else grace_s)
            log.warning("serving drain: %s (grace %.1fs)", reason,
                        self._drain_deadline - self.clock())

    def _install_signals(self):
        # the handler only SETS A FLAG (locklint LK005): it runs
        # between bytecodes of the drive loop itself — logging (the
        # drain banner), the flight dump's file I/O, and the ledger
        # walk all re-enter non-reentrant state if done here. step()
        # consumes the flag at its next iteration.
        def handler(signum, frame):
            self._pending_signal = signum

        try:
            return {s: signal.signal(s, handler)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        except ValueError:          # not the main thread
            return None

    def _write_drain_report(self) -> dict:
        report = {
            "reason": self._drain_reason,
            "counters": self.counters(),
            "steps": self.stats.steps,
            "tokens": self.stats.tokens,
            "requests": [
                {"req_id": r.req_id, "outcome": r.outcome,
                 "tokens": len(r.tokens), "retries": r.retries,
                 "error": r.error}
                for _, r in sorted(self.results.items())
            ],
        }
        self.drain_report = report
        if self.drain_report_path:
            tmp = f"{self.drain_report_path}.tmp"
            with open(tmp, "w") as f:
                json.dump(report, f, indent=1)
            os.replace(tmp, self.drain_report_path)
        return report

    # -- pool plumbing -----------------------------------------------------

    def _fold_pool_counters(self) -> None:
        """Bank the retiring PagePool's counters before a fresh one
        replaces it (decode-fault reset / backend switch) so
        counters() never goes backwards."""
        if self._active_pool is None:
            return
        pc = self._active_pool.counters()
        for k in _POOL_COUNTER_KEYS:
            self._pool_base[k] += pc[k]
        self._pool_base["peak_pages_in_use"] = max(
            self._pool_base["peak_pages_in_use"],
            pc["peak_pages_in_use"])
        self._active_pool = None

    def _reset_pool(self) -> None:
        self._fold_pool_counters()
        # a fresh pool generation invalidates any parked handoffs —
        # their export pins die with the old pool, and the requests
        # themselves ride the requeue path (_evict_in_flight)
        self._handoff.clear()
        self._state = self._backend.init_state()
        self._slot_req = [None] * self._backend.slots
        self._prefilling.clear()
        self._active_pool = getattr(self._backend, "pool", None)
        if self._active_pool is not None and (
                self.tracer is not None or self.flight is not None):
            self._active_pool.obs_hook = self._pool_obs

    def _bucketed(self, req: Request) -> np.ndarray:
        # the engine's own padding convention; _validate already
        # guaranteed a bucket fits, so this cannot raise here
        padded, _ = pad_to_bucket(req.prompt, self.buckets)
        return padded

    def _requeue_or_fail(self, req: Request, why: str) -> None:
        """The slot-level retry path: transient faults requeue at the
        FRONT (the request already waited its turn) until the budget
        is spent."""
        if req.retries_left > 0:
            req.retries_left -= 1
            self.stats.retried += 1
            self._emitted.pop(req.req_id, None)
            self._lps.pop(req.req_id, None)
            self.queue.insert(0, req)
            self._trace_event(req.req_id, "retried", why=why,
                              retries_left=req.retries_left)
            log.warning("request %d requeued after %s (%d retries "
                        "left)", req.req_id, why, req.retries_left)
        else:
            self._finish(req, FAILED, error=(
                f"transient-fault retry budget exhausted: {why}"),
                retries=self.max_retries)

    def _evict_in_flight(self, why: str) -> None:
        """Pull every in-flight request back into the queue (or fail
        it) and reset the device pool — the backend-fault path."""
        inflight = [r for r in self._slot_req if r is not None]
        # queue-front order: keep the original admission order
        for req in reversed(inflight):
            self._requeue_or_fail(req, why)
        self._reset_pool()

    def _native_fault(self, exc: Exception) -> None:
        """Record a native-backend fault with the breaker; switch to
        the primary engine once it opens."""
        if self._backend is not self.native_backend:
            return
        self.breaker.record_failure()
        if not self.breaker.allow() or self.breaker.state != "closed":
            log.warning("circuit breaker %s after native fault (%s); "
                        "falling back to the primary engine",
                        self.breaker.state, exc)
            if self.flight is not None:
                self.flight.record("breaker", "breaker-open",
                                   state=self.breaker.state,
                                   failures=self.breaker.failures,
                                   trips=self.breaker.trips,
                                   error=str(exc))
                self._flight_dump("breaker-open", error=str(exc))
            self._backend = self.engine
            self._evict_in_flight(f"native backend fault: {exc}")

    def _maybe_probe_native(self) -> None:
        """Empty-pool moment + half-open breaker => route the next
        admissions through the native backend again (the probe)."""
        if (self.native_backend is None
                or self._backend is self.native_backend
                or any(r is not None for r in self._slot_req)):
            return
        if self.breaker.allow():
            log.info("circuit breaker %s: probing the native backend",
                     self.breaker.state)
            self._backend = self.native_backend
            self._reset_pool()

    def _retire_slot(self, slot: int) -> None:
        """Host-side slot free via the engine's own retire convention
        (release_slot) — the deadline/drain/exhaustion evictions and
        serve()'s token-budget retire share one sentinel arithmetic,
        and on a paged engine release_slot is ALSO what frees the
        slot's pages, so every retirement (device-finished rows
        included) must route here."""
        req = self._slot_req[slot]
        if req is not None:
            # a parked handoff retired locally (deadline expiry,
            # drain grace, preemption) abandons its transfer: drop
            # the export pin so the pool's books stay balanced
            self._drop_handoff_pin(req.req_id)
        self._state = self._backend.release_slot(self._state, slot)
        self._slot_req[slot] = None
        self._prefilling.pop(slot, None)

    def _drop_handoff_pin(self, req_id: int) -> None:
        h = self._handoff.pop(req_id, None)
        if h is not None:
            if self._active_pool is not None:
                self._active_pool.release_export(h["export_id"])
            self._free_ticket(h)

    # -- the drive loop ----------------------------------------------------

    def _advance_prefills(self) -> None:
        """One prefill chunk per mid-prefill slot per loop iteration —
        the interleave that keeps a long prompt from head-of-line
        stalling active decodes. Faults during a chunk use the same
        requeue/fail discipline as one-shot prefill (the wrapped
        engine raises BEFORE touching the state; the slot's pages are
        freed by the retire)."""
        for slot in self.policy.prefill_slots(list(self._prefilling)):
            ticket = self._prefilling.get(slot)
            req = self._slot_req[slot]
            if ticket is None or req is None:
                continue
            try:
                self._state, done = self._backend.prefill_advance(
                    self._state, ticket)
            except ValueError as e:
                self._retire_slot(slot)
                self._finish(req, FAILED,
                             error=f"prefill rejected: {e}")
                continue
            except Exception as e:
                if _replica_fatal(e):
                    raise       # dead backend: the router's problem
                if self._backend is self.native_backend:
                    self._native_fault(e)
                if self._slot_req[slot] is req:
                    self._retire_slot(slot)
                    self._requeue_or_fail(req,
                                          f"prefill chunk fault: {e}")
                continue
            if self._backend is self.native_backend:
                self.breaker.record_success()
            if done:
                self._prefilling.pop(slot, None)
                if self.role == "prefill":
                    # the disaggregation seam: a prefill-tier replica
                    # never decodes — park the finished prefill for
                    # KV-block migration to the decode tier
                    self._park_for_handoff(slot)

    def _ensure_pages(self, slot: int, req: Request) -> None:
        """Map the next write position's page for a continuing slot.
        On PoolExhaustedError — only possible when num_pages
        over-subscribes the slots — evict the LOWEST-PRIORITY
        (highest req_id = latest submitted) in-flight request back
        onto the queue (recompute preemption: one retry-budget unit,
        tokens identical on replay) and retry; the needy request
        itself yields when it IS the junior one. Priority is total,
        so the most senior request always progresses — no mutual-
        preemption livelock — and retry budgets bound the recompute
        thrash. With nobody else holding pages, retire THIS request
        at pool capacity, the paged analog of the max_len
        retirement."""
        ensure = getattr(self._backend, "ensure_decode_page", None)
        if ensure is None:
            return
        while True:
            try:
                self._state = ensure(self._state, slot)
                return
            except PoolExhaustedError as e:
                holders = [
                    (s2, r2) for s2, r2 in enumerate(self._slot_req)
                    if r2 is not None]
                s2 = self.policy.preemption_victim(
                    [(s_, r_.req_id) for s_, r_ in holders])
                r2 = self._slot_req[s2]
                if s2 == slot and len(holders) == 1:
                    self._retire_slot(slot)
                    self._finish(
                        req, COMPLETED,
                        retries=self.max_retries - req.retries_left)
                    return
                self._retire_slot(s2)
                self._requeue_or_fail(
                    r2, f"preempted on page-pool exhaustion: {e}")
                if s2 == slot:
                    return          # the needy request yielded

    def _propose_and_reserve(self):
        """Draft phase of one speculative round (speculative=True):
        per decoding slot, the policy's clamped draft budget, the
        proposer's tokens over prompt + emitted history, and the
        verify window's page reservation. A slot whose reservation
        the pool refuses degrades to a 0-draft plain round —
        speculation never preempts a co-tenant. Returns the padded
        (drafts [S, spec_draft_max], draft_len [S]) host arrays
        spec_step stages."""
        kmax = int(self.policy.spec_draft_max)
        drafts = np.zeros((len(self._slot_req), kmax), np.int32)
        dlen = np.zeros((len(self._slot_req),), np.int32)
        pool = self._backend.pool
        for slot, req in enumerate(self._slot_req):
            if (req is None or slot in self._prefilling
                    or req.req_id in self._handoff):
                continue
            rid = req.req_id
            budget = self.policy.draft_len(
                pos=pool.slot_pos[slot],
                max_len=self._backend.max_len,
                remaining=req.max_new - len(self._emitted[rid]))
            prop = []
            if budget > 0:
                hist = ([int(x) for x in req.prompt]
                        + self._emitted[rid])
                # draft() self-extends through looped output; custom
                # proposers may only define propose()
                draft_fn = getattr(self.proposer, "draft",
                                   self.proposer.propose)
                prop = draft_fn(hist, budget)[:budget]
            if prop:
                try:
                    self._state = self._backend.reserve_spec_pages(
                        self._state, slot, len(prop))
                except PoolExhaustedError:
                    prop = []
            drafts[slot, :len(prop)] = prop
            dlen[slot] = len(prop)
            self.stats.draft_proposed += len(prop)
        return drafts, dlen

    def _settle_spec(self, slot: int, req: Request,
                     n_emit: int) -> None:
        """Commit/rollback for one CONTINUING slot after a verify
        round: advance the pool to the accepted length, map the next
        write block, return the rejected tail's pages. The boundary
        alloc can exhaust an over-subscribed pool mid-round — same
        preemption discipline as _ensure_pages (evict the junior
        in-flight request and retry; the needy request yields when it
        IS the junior one, or retires at pool capacity when alone)."""
        while True:
            try:
                self._state = self._backend.settle_spec(
                    self._state, slot, n_emit)
                return
            except PoolExhaustedError as e:
                holders = [
                    (s2, r2) for s2, r2 in enumerate(self._slot_req)
                    if r2 is not None]
                s2 = self.policy.preemption_victim(
                    [(s_, r_.req_id) for s_, r_ in holders])
                r2 = self._slot_req[s2]
                if s2 == slot and len(holders) == 1:
                    self._retire_slot(slot)
                    self._finish(
                        req, COMPLETED,
                        retries=self.max_retries - req.retries_left)
                    return
                self._retire_slot(s2)
                self._requeue_or_fail(
                    r2, f"preempted on page-pool exhaustion: {e}")
                if s2 == slot:
                    return          # the needy request yielded

    def _expire_queued(self) -> None:
        now = self.clock()
        for req in [r for r in self.queue
                    if r.deadline is not None and now >= r.deadline]:
            self.queue.remove(req)
            self._finish(req, EXPIRED, error=(
                f"deadline expired after {now - req.submitted_at:.3f}s "
                f"in queue (never admitted)"))

    def _admit(self) -> None:
        while not self._draining and self.queue and any(
                r is None for r in self._slot_req):
            self._admitting_req = None
            slot = self._slot_req.index(None)
            idx = self.policy.next_index(self.queue)
            req = self.queue.pop(idx)
            now = self.clock()
            if req.deadline is not None and now >= req.deadline:
                self._finish(req, EXPIRED, error=(
                    "deadline expired at admission (prefill skipped)"))
                continue
            pool = getattr(self._backend, "pool", None)
            # the binding resource on a paged engine is PAGES, not
            # slots: the policy defers admission while the pool could
            # not map the request's post-prefix-reuse need right now —
            # in-flight work frees pages, and with nothing in flight
            # the whole pool is available (submit() already rejected
            # what can never fit). can_admit mirrors admit()'s own
            # reclaim arithmetic, so a passed gate cannot raise a
            # spurious PoolExhaustedError
            if not self.policy.can_admit(pool, req.prompt,
                                         req.true_len):
                self.queue.insert(idx, req)
                break
            chunked = (getattr(self._backend, "prefill_chunk", None)
                       is not None
                       and hasattr(self._backend, "prefill_begin"))
            self._admitting_req = req
            try:
                if chunked:
                    self._state, ticket = self._backend.prefill_begin(
                        self._state, slot, self._bucketed(req),
                        true_len=req.true_len, sampling=req.sampling)
                    self._prefilling[slot] = ticket
                else:
                    self._state = self._backend.prefill(
                        self._state, slot, self._bucketed(req),
                        true_len=req.true_len, sampling=req.sampling)
            except ValueError as e:
                # deterministic rejection — retrying cannot help
                self._finish(req, FAILED, error=f"prefill rejected: {e}")
                continue
            except PoolExhaustedError as e:
                # capacity pressure, NOT backend ill-health: never
                # feeds the circuit breaker (admit/begin leave the
                # pool untouched on failure); ordinary requeue path
                self._requeue_or_fail(req, f"prefill fault: {e}")
                continue
            except Exception as e:
                if _replica_fatal(e):
                    # dead backend: requeue the request UNCHARGED (the
                    # fault is the replica's, not the request's) and
                    # let the router take over
                    self.queue.insert(0, req)
                    raise
                # transient fault (an injected engine fault or a
                # native bridge error): the held state is untouched
                # (prefill is pure / begin leaves the pool untouched
                # on failure), so only THIS request is suspect —
                # unless the breaker opens, which evicts the pool and
                # switches backends first
                if self._backend is self.native_backend:
                    self._native_fault(e)
                self._requeue_or_fail(req, f"prefill fault: {e}")
                continue
            if self._backend is self.native_backend:
                self.breaker.record_success()
            self.stats.prefills += 1
            self.stats.admitted += 1
            self._slot_req[slot] = req
            self._emitted[req.req_id] = []
            self._lps[req.req_id] = []
            self._trace_event(req.req_id, "admitted", slot=slot,
                              backend=self._backend_name(),
                              chunked=chunked)
            if self.role == "prefill" and not chunked:
                # one-shot prefill finished inside admission: park
                # immediately (the chunked path parks at its final
                # chunk in _advance_prefills)
                self._park_for_handoff(slot)
        self._admitting_req = None

    def _expire_in_flight(self) -> None:
        now = self.clock()
        for slot, req in enumerate(self._slot_req):
            if req is None or req.deadline is None:
                continue
            if now >= req.deadline:
                self._finish(req, EXPIRED, error=(
                    f"deadline expired mid-generation after "
                    f"{len(self._emitted.get(req.req_id, []))} tokens"))
                self._retire_slot(slot)

    def _drain_expired(self) -> bool:
        return (self._draining and self._drain_deadline is not None
                and self.clock() >= self._drain_deadline)

    def step(self) -> bool:
        """ONE drive-loop iteration: shed/expire/admit, advance one
        prefill chunk per pending slot, run at most one decode step,
        mirror its tokens, map pages, expire deadlines, fire `on_step`
        hooks. Returns True while work remains (queued or in-flight),
        False once idle — `run()` loops this, and the fleet router
        (`serve.router.ServingRouter`) round-robins it across replicas
        so one slow replica cannot stall the others.

        A replica-fatal backend error (`_replica_fatal`) propagates
        out of here with the host-side ledger (queue + slot
        assignments) INTACT — the router harvests it to redistribute
        with retry budgets preserved."""
        if self._state is None:
            self._reset_pool()
        signum = self._pending_signal
        if signum is not None:
            self._pending_signal = None
            if self.flight is not None:
                self.flight.record("signal", f"signal-{signum}")
                self._flight_dump(f"signal-{signum}")
            self.drain(reason=f"signal {signum}")
        if self._draining:
            for req in list(self.queue):
                self.queue.remove(req)
                self._finish(req, SHED, error=(
                    f"load shed: draining "
                    f"({self._drain_reason})"))
        self._expire_queued()
        self._maybe_probe_native()
        self._admit()
        self._advance_prefills()
        parked = {h["slot"] for h in self._handoff.values()}
        inflight = [r for s, r in enumerate(self._slot_req)
                    if r is not None and s not in parked]
        if not inflight:
            # parked handoffs progress via the router's export/ACK
            # cycle, not the drive loop — but their deadlines still
            # bind while they wait for a destination
            if parked:
                self._expire_in_flight()
            return bool(self.queue) and not self._draining
        if self._drain_expired():
            # before the mid-prefill early-out: the drain grace must
            # bind even when every occupied slot is still prefilling
            # (a long chunked prompt must not overstay the grace by
            # its remaining chunks)
            for slot, req in enumerate(self._slot_req):
                if req is not None:
                    self._finish(req, EXPIRED, error=(
                        f"drain grace expired "
                        f"({self._drain_reason})"))
                    self._retire_slot(slot)
            return True
        decoding = sum(r is not None and s not in self._prefilling
                       and s not in parked
                       for s, r in enumerate(self._slot_req))
        if not self.policy.should_decode(decoding,
                                         len(self._prefilling)):
            # only mid-prefill slots: no decode yet — but per-request
            # deadlines bind a mid-prefill slot exactly like a
            # decoding one
            self._expire_in_flight()
            return True
        # speculative rounds run only on the primary paged engine
        # (a native backend without spec_step, or the ring pool,
        # falls back to plain one-token steps — graceful degrade,
        # not an error)
        spec = (self.speculative
                and self._backend is self.engine
                and getattr(self._backend, "pool", None) is not None
                and hasattr(self._backend, "spec_step"))
        if spec:
            drafts, dlen = self._propose_and_reserve()
        try:
            if spec:
                (self._state, em, em_lp, n_emit, was_active, fin,
                 n_acc) = self._backend.spec_step(self._state,
                                                  drafts, dlen)
            else:
                (self._state, toks, tok_lps, was_active,
                 fin) = self._backend.decode_step(self._state)
        except Exception as e:
            if _replica_fatal(e):
                raise           # dead backend: the router's problem
            if self._backend is self.native_backend:
                self._native_fault(e)
                if self._backend is self.native_backend:
                    # breaker still closed: retry on native
                    self._evict_in_flight(f"decode fault: {e}")
            else:
                self._evict_in_flight(f"decode fault: {e}")
            return True
        if self._backend is self.native_backend:
            self.breaker.record_success()
        self.stats.steps += 1
        if spec:
            self.stats.spec_rounds += 1
            (em, em_lp, n_emit_h, was_active_h, fin_h,
             n_acc_h) = _host_copy(em, em_lp, n_emit, was_active, fin,
                                   n_acc)
            for slot, req in enumerate(self._slot_req):
                if req is None or slot in self._prefilling \
                        or not was_active_h[slot]:
                    continue
                ne = int(n_emit_h[slot])
                self.stats.draft_accepted += int(n_acc_h[slot])
                rid = req.req_id
                for j in range(ne):
                    self._emitted[rid].append(int(em[slot, j]))
                    self._lps[rid].append(float(em_lp[slot, j]))
                self.stats.tokens += ne
                done = (bool(fin_h[slot]) or
                        len(self._emitted[rid]) >= req.max_new)
                if done:
                    self._retire_slot(slot)
                    self._finish(
                        req, COMPLETED,
                        retries=self.max_retries - req.retries_left)
                else:
                    self._settle_spec(slot, req, ne)
        else:
            toks, tok_lps, was_active_h, fin_h = _host_copy(
                toks, tok_lps, was_active, fin)
            for slot, req in enumerate(self._slot_req):
                if req is None or slot in self._prefilling \
                        or not was_active_h[slot]:
                    continue
                self._emitted[req.req_id].append(int(toks[slot]))
                self._lps[req.req_id].append(float(tok_lps[slot]))
                self.stats.tokens += 1
                done = (bool(fin_h[slot]) or
                        len(self._emitted[req.req_id])
                        >= req.max_new)
                if done:
                    # device-finished and budget-finished rows retire
                    # the same way: the paged pool frees this slot's
                    # pages in release_slot
                    self._retire_slot(slot)
                    self._finish(
                        req, COMPLETED,
                        retries=self.max_retries - req.retries_left)
                else:
                    self._ensure_pages(slot, req)
        self._expire_in_flight()
        for hook in list(self.on_step):
            hook(self, self.stats.steps)
        return True

    def run(self) -> Dict[int, RequestResult]:
        """Serve until the queue and pool are empty (or the drain
        grace ends). Safe to call repeatedly — new `submit()`s between
        runs (or from `on_step` hooks during one) extend the same
        accounting. Returns `self.results`."""
        prev_handlers = (self._install_signals()
                         if self.install_signal_handlers else None)
        if self._state is None:
            self._reset_pool()
        try:
            while self.step():
                pass
        finally:
            if prev_handlers:
                for s, h in prev_handlers.items():
                    signal.signal(s, h)
        if self._draining:
            self._write_drain_report()
        return self.results

    # -- observability -----------------------------------------------------

    def ping(self) -> None:
        """Health check: touch the ACTIVE backend's probe surface so
        a dead engine raises its replica-fatal error here instead of
        mid-burst. Pure host-side — no device work."""
        fn = getattr(self._backend, "ping", None)
        if fn is not None:
            fn()

    def load(self) -> int:
        """Host-side load gauge: queued + in-flight requests. The
        fleet router's least-loaded spill reads this — pure host
        state, no device sync."""
        return len(self.queue) + sum(
            r is not None for r in self._slot_req)

    def pending_requests(self) -> List[Request]:
        """Every request with NO terminal outcome yet — in-flight
        first (slot order, the admission order preserved), then the
        queue. This is the host-side scheduler LEDGER: when a
        replica's device dies mid-burst (its engine raises a
        replica-fatal error), the ledger is exactly what survives,
        and the router harvests it to resubmit each request to a
        survivor with its remaining `retries_left` intact — never
        zero outcomes (nothing silently lost with the device), never
        two (anything already in `results` is NOT pending)."""
        return ([r for r in self._slot_req if r is not None]
                + list(self.queue))

    def counters(self) -> Dict[str, int]:
        """The structured outcome counters (PoolStats fields):
        admitted/shed/expired/retried/completed/failed + requests,
        plus the page-pool block (pages_in_use/pages_free are live
        gauges of the current pool generation; prefix_hits/
        prefix_misses/prefix_rejected/prefill_chunks and
        peak_pages_in_use accumulate across generations)."""
        out = {
            "requests": self.stats.requests,
            "admitted": self.stats.admitted,
            "completed": self.stats.completed,
            "expired": self.stats.expired,
            "shed": self.stats.shed,
            "failed": self.stats.failed,
            "retried": self.stats.retried,
            # speculative decoding: draft tokens proposed/accepted
            # and the derived acceptance rate (a float gauge — the
            # obs registry's sources export numerics as-is)
            "spec_rounds": self.stats.spec_rounds,
            "draft_proposed": self.stats.draft_proposed,
            "draft_accepted": self.stats.draft_accepted,
            "acceptance_rate": self.stats.acceptance_rate(),
            # serving-artifact adoption (per replica, so the router's
            # fleet counters sum them)
            "artifact_loads": getattr(self.engine,
                                      "artifact_loads", 0),
            "artifact_fallbacks": getattr(self.engine,
                                          "artifact_fallbacks", 0),
            # disaggregation: whole-request migrations through this
            # replica (the pool's migrated_*_pages count pages). A
            # migrated-out request leaves `requests`/`admitted` (the
            # destination owns its outcome) but stays visible here.
            "migrated_in": self.migrated_in,
            "migrated_out": self.migrated_out,
            "handoffs_ready": len(self._handoff),
            "handoffs_cancelled": self.handoffs_cancelled,
            # data-plane degrades (arena attach/scatter/gather
            # failures that fell back to the inline pickle path).
            # The arena's OWN gauges are deliberately not summed
            # here — the arena is fleet-shared, and per-replica sums
            # would multiply-count it; it binds to the registry once
            # via ShmArena.bind_metrics.
            "data_plane_fallbacks": self.data_plane_fallbacks,
        }
        out.update(self._pool_base)
        out.setdefault("pages_in_use", 0)
        out.setdefault("pages_free", 0)
        if self._active_pool is not None:
            pc = self._active_pool.counters()
            for k in _POOL_COUNTER_KEYS:
                out[k] = self._pool_base[k] + pc[k]
            out["pages_in_use"] = pc["pages_in_use"]
            out["pages_free"] = pc["pages_free"]
            out["peak_pages_in_use"] = max(
                self._pool_base["peak_pages_in_use"],
                pc["peak_pages_in_use"])
        return out

    def reconcile(self) -> None:
        """Assert the accounting contract: every submitted request has
        exactly one terminal outcome, the counters match the request
        log, and the page pool's books balance (allocated = in-use +
        free, every held page refcounted, refcounts == holder counts
        — PagePool.reconcile). Raises AssertionError on any silent
        drop — the chaos harness calls this after every burst."""
        assert len(self.results) == self.stats.requests, (
            len(self.results), self.stats.requests)
        assert not self.queue and not any(
            r is not None for r in self._slot_req), "work still pending"
        tally: Dict[str, int] = {o: 0 for o in OUTCOMES}
        for res in self.results.values():
            assert res.outcome in OUTCOMES, res
            tally[res.outcome] += 1
        for o in OUTCOMES:
            assert tally[o] == getattr(self.stats, o), (
                o, tally[o], getattr(self.stats, o))
        if self._active_pool is not None:
            self._active_pool.reconcile()
            # an idle server holds no pages outside the prefix cache
            pool = self._active_pool
            assert all(not p for p in pool.slot_pages), pool.slot_pages
            # cross-ledger: every outstanding export pin belongs to a
            # parked handoff and vice versa — a dropped ACK can leak
            # on either side, and each side's books must name it
            assert sorted(h["export_id"]
                          for h in self._handoff.values()) \
                == sorted(pool.export_ids()), (
                self._handoff, pool.export_ids())
        if self.data_plane is not None:
            # the arena's live tickets FOR THIS PROCESS are exactly
            # the parked handoffs' tickets (the third ledger)
            mine = {int(h["ticket"]["tag"])
                    for h in self._handoff.values() if "ticket" in h}
            live = self.data_plane.live_tags(os.getpid())
            assert live == mine, (live, mine)
