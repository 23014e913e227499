"""Span tracing: per-request / per-step audit trail.

Request-ids are minted once — at `ServingRouter.submit` (`rr<N>`) or
by a standalone `ServingServer` (`req<N>`) — and the id rides the
request through replica -> `ServingServer.step()` -> `DecodeEngine`
prefill/decode -> `PagePool` admit/evict, and trainer iteration ->
pserver push/pull. Each hop appends an *event* to the request's span;
the span ends EXACTLY ONCE, with the terminal outcome as a tag
(completed/expired/shed/failed for serve; ok/rollback/drain for
train). That makes the exactly-once accounting contract auditable
per request, not just in aggregate: `tests/test_obs.py` kills a
replica mid-burst and asserts every minted id has exactly one
terminal span whose outcomes sum to the fleet counters.

Overhead rules (same as the registry): host-side only, no jax
imports, no device values in tags/events — a span is a few dict ops
off the jitted bodies. Clock is injectable so ManualClock chaos runs
get deterministic durations.

A span that is ended twice does not assert (production telemetry
must not take the server down); the second end is recorded in
`Tracer.double_ends` and the test suite asserts that stays zero.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

__all__ = ["Span", "Tracer"]

#: finished spans kept in the tracer ring (flight recorder keeps its
#: own, possibly longer, ring)
DEFAULT_KEEP = 1024


class Span:
    """One traced unit of work. Mutable while open; `end()` (via the
    owning Tracer) freezes it with a terminal outcome tag."""

    __slots__ = ("trace_id", "name", "start", "end_time", "tags",
                 "events", "_tracer")

    def __init__(self, trace_id: str, name: str, start: float,
                 tracer: "Tracer", tags: Optional[Dict[str, object]]
                 = None):
        self.trace_id = trace_id
        self.name = name
        self.start = start
        self.end_time: Optional[float] = None
        self.tags: Dict[str, object] = dict(tags or {})
        self.events: List[Dict[str, object]] = []
        self._tracer = tracer

    @property
    def open(self) -> bool:
        return self.end_time is None

    @property
    def outcome(self) -> Optional[str]:
        return self.tags.get("outcome")

    def event(self, name: str, **data: object) -> None:
        """Append a point-in-time event (admitted, retried,
        redistributed, page_admit, push, ...). No-op on a closed
        span except for a `late_event` tally on the tracer — late
        stragglers must not resurrect a terminal span."""
        if self.end_time is not None:
            self._tracer.late_events += 1
            return
        self.events.append(
            {"t": self._tracer.clock(), "name": name, **data})

    def duration(self) -> Optional[float]:
        if self.end_time is None:
            return None
        return self.end_time - self.start

    def to_dict(self) -> Dict[str, object]:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "start": self.start,
            "end": self.end_time,
            "tags": dict(self.tags),
            "events": list(self.events),
        }


class Tracer:
    """Mints and finishes spans; forwards finished spans to an
    optional sink (the flight recorder's `note_span`).

    Live spans are indexed by trace_id so instrumentation points deep
    in the stack (PagePool hooks, pserver client) can attach events
    knowing only the id. The live index is bounded implicitly by the
    server's own admission control (slots + queue cap); finished
    spans go to a fixed ring."""

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 sink: Optional[Callable[[Span], None]] = None,
                 keep: int = DEFAULT_KEEP):
        self.clock = clock if clock is not None else time.monotonic
        self.sink = sink
        self._lock = threading.Lock()
        self._live: Dict[str, Span] = {}
        self.finished: Deque[Span] = collections.deque(maxlen=keep)
        self.started = 0
        self.ended = 0
        self.double_ends = 0
        self.late_events = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self, trace_id: str, name: str,
              **tags: object) -> Span:
        """Open a span. A second start() for a live id records a
        `respan` tag on the existing span and returns it — ids are
        minted once, so this only happens on instrumentation bugs
        and must not fork the audit trail."""
        with self._lock:
            existing = self._live.get(trace_id)
            if existing is not None and existing.open:
                existing.tags["respan"] = (
                    int(existing.tags.get("respan", 0)) + 1)
                return existing
            span = Span(trace_id, name, self.clock(), self, tags)
            self._live[trace_id] = span
            self.started += 1
            return span

    def get(self, trace_id: str) -> Optional[Span]:
        with self._lock:
            return self._live.get(trace_id)

    def event(self, trace_id: str, name: str, **data: object) -> None:
        """Attach an event to a live span by id; silently dropped for
        unknown ids (a component may be traced standalone)."""
        span = self.get(trace_id)
        if span is not None:
            span.event(name, **data)

    def end(self, trace_id_or_span, outcome: str,
            **tags: object) -> Optional[Span]:
        """Terminate a span with its outcome tag. Exactly-once: a
        second end bumps `double_ends` and changes nothing."""
        if isinstance(trace_id_or_span, Span):
            span = trace_id_or_span
        else:
            span = self.get(trace_id_or_span)
        if span is None:
            return None
        with self._lock:
            if span.end_time is not None:
                self.double_ends += 1
                return span
            span.end_time = self.clock()
            span.tags["outcome"] = outcome
            span.tags.update(tags)
            self._live.pop(span.trace_id, None)
            self.finished.append(span)
            self.ended += 1
        if self.sink is not None:
            try:
                self.sink(span)
            except Exception:
                pass  # telemetry must never take the caller down
        return span

    # -- audit -------------------------------------------------------------

    def live_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._live)

    def terminal_outcomes(self) -> Dict[str, List[str]]:
        """trace_id -> [outcome per finished span]. The exactly-once
        audit: every id should map to exactly one outcome."""
        out: Dict[str, List[str]] = {}
        with self._lock:
            for span in self.finished:
                out.setdefault(span.trace_id, []).append(
                    span.tags.get("outcome", "?"))
        return out

    def outcome_counts(self) -> Dict[str, int]:
        """Tally of finished-span outcomes — comparable 1:1 with the
        server/router ledger counters."""
        out: Dict[str, int] = {}
        with self._lock:
            for span in self.finished:
                oc = str(span.tags.get("outcome", "?"))
                out[oc] = out.get(oc, 0) + 1
        return out

    def counters(self) -> Dict[str, int]:
        """Tracer self-accounting, registry-source shaped."""
        with self._lock:
            return {
                "spans_started": self.started,
                "spans_ended": self.ended,
                "spans_live": len(self._live),
                "double_ends": self.double_ends,
                "late_events": self.late_events,
            }
