"""Unified observability layer (a copy of `paddle_tpu.obs`, which is
framework-free).

Three host-side pieces, all with injectable clocks and zero device
interaction (clean under `transfer_guard("disallow")`, no compile
keys):

  - `registry`  — metrics registry; existing component ledgers
                  (PoolStats, server/router counters, pserver shard
                  stats) register as read-through *sources*, so
                  exported metrics and `reconcile()` invariants read
                  the same numbers.
  - `trace`     — per-request / per-step spans with exactly-once
                  terminal outcomes.
  - `flight`    — ring-buffer flight recorder, dumped on faults
                  (replica death, breaker-open, divergence rollback,
                  SIGTERM, steady-state recompiles).

See docs/OBSERVABILITY.md for the metric catalog, span schema, and
the flight-recorder workflow.
"""

from paddle_tpu_torch.obs.flight import (FlightRecorder, get_default,
                                   peek_default, set_default)
from paddle_tpu_torch.obs.registry import (Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry,
                                     sanitize_value)
from paddle_tpu_torch.obs.trace import Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "sanitize_value",
    "Span", "Tracer",
    "FlightRecorder", "get_default", "peek_default", "set_default",
]
