"""Metrics registry: one place every exported number comes from.

The reliability substrate already keeps careful books — `PoolStats`,
`ServingServer.counters()`, the router's `fleet_*` aggregates,
`ResilientTrainer` outcome counts, pserver shard `stats()` — and each
of those ledgers is asserted internally by a `reconcile()`. The
registry deliberately does NOT duplicate that state: components
register their existing counter dicts as *sources*
(`register_source`), so a snapshot reads the SAME numbers the
invariants check, at snapshot time, with zero hot-path overhead.
Registry-native instruments (Counter/Gauge/Histogram) exist for
values that have no pre-existing ledger (request latency, span
timings).

Design constraints (the overhead gate):
  - host-side only: no jax imports, nothing here may touch a device
    value — instrumentation must run clean under
    `transfer_guard("disallow")` and add no compile keys;
  - injectable clock (`clock=`), so chaos tests drive deterministic
    timestamps via `testing.faults.ManualClock`;
  - bounded cardinality: each metric holds at most
    `max_series_per_metric` label-sets; overflow lands in a single
    `...{overflow="true"}` series and is counted in
    `obs_dropped_series`, never an unbounded dict (a misbehaving
    label like raw request-ids cannot OOM the server).

Exporters: `to_prometheus()` (text exposition format) and
`to_jsonl()` (one JSON object per series — the bench stages embed
these snapshots into `BENCH_*.json`).
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "sanitize_value",
]

#: label values beyond this many series per metric collapse into one
#: overflow series — bounded memory under label-cardinality mistakes
DEFAULT_MAX_SERIES = 64

#: default latency buckets (seconds) — tuned for request/step scale
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                   30.0, float("inf"))

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

LabelKey = Tuple[Tuple[str, str], ...]


def _metric_name(name: str) -> str:
    """Prometheus-legal metric name (collapse anything exotic to _)."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _label_key(labels: Optional[Mapping[str, str]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def sanitize_value(v: object) -> Optional[float]:
    """Source dicts carry more than numbers (`replica_lost` bool,
    `last_snapshot_error` str-or-None). Exported metrics are numeric:
    bool -> 0/1, int/float pass through, everything else is dropped
    (None, strings, nested dicts)."""
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    return None


class Counter:
    """Monotonic per-label-set counter."""

    kind = "counter"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._r = registry
        self._series: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0,
            labels: Optional[Mapping[str, str]] = None) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc "
                             f"{amount}")
        key = self._r._admit(self, _label_key(labels))
        with self._r._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, labels: Optional[Mapping[str, str]] = None) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def _rows(self) -> List[Tuple[LabelKey, str, float]]:
        return [(k, "", v) for k, v in sorted(self._series.items())]


class Gauge:
    """Set-to-current-value instrument."""

    kind = "gauge"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._r = registry
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float,
            labels: Optional[Mapping[str, str]] = None) -> None:
        key = self._r._admit(self, _label_key(labels))
        with self._r._lock:
            self._series[key] = float(value)

    def value(self, labels: Optional[Mapping[str, str]] = None) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def _rows(self) -> List[Tuple[LabelKey, str, float]]:
        return [(k, "", v) for k, v in sorted(self._series.items())]


class Histogram:
    """Fixed-bucket histogram (cumulative counts + sum + count).

    Buckets are chosen at construction — observing is two bisect-free
    comparisons per bucket, no allocation, fine for the serve hot
    path's host side."""

    kind = "histogram"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        bs = sorted(float(b) for b in buckets)
        if not bs or bs[-1] != float("inf"):
            bs.append(float("inf"))
        self.name = name
        self.help = help
        self.buckets = tuple(bs)
        self._r = registry
        # per label-set: [bucket counts..., sum, count]
        self._series: Dict[LabelKey, List[float]] = {}

    def observe(self, value: float,
                labels: Optional[Mapping[str, str]] = None) -> None:
        key = self._r._admit(self, _label_key(labels))
        with self._r._lock:
            row = self._series.get(key)
            if row is None:
                row = [0.0] * (len(self.buckets) + 2)
                self._series[key] = row
            for i, b in enumerate(self.buckets):
                if value <= b:
                    row[i] += 1.0
            row[-2] += float(value)
            row[-1] += 1.0

    def count(self, labels: Optional[Mapping[str, str]] = None) -> float:
        row = self._series.get(_label_key(labels))
        return row[-1] if row else 0.0

    def sum(self, labels: Optional[Mapping[str, str]] = None) -> float:
        row = self._series.get(_label_key(labels))
        return row[-2] if row else 0.0

    def quantile(self, q: float,
                 labels: Optional[Mapping[str, str]] = None
                 ) -> Optional[float]:
        """Bucket-resolution quantile estimate: the UPPER BOUND of
        the first bucket whose cumulative count reaches `q` of the
        total — the standard Prometheus-style read, conservative by
        one bucket width. Returns None with no observations, and the
        highest FINITE bound when the quantile lands in the +Inf
        bucket (there is no meaningful number past it). The fleet
        autoscaler reads p99 from here."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        row = self._series.get(_label_key(labels))
        if row is None or row[-1] == 0:
            return None
        need = q * row[-1]
        for i, b in enumerate(self.buckets):
            if row[i] >= need and row[i] > 0:
                if b == float("inf"):
                    finite = [x for x in self.buckets
                              if x != float("inf")]
                    return finite[-1] if finite else None
                return b
        return None             # pragma: no cover (inf is cumulative)

    def _rows(self) -> List[Tuple[LabelKey, str, float]]:
        out: List[Tuple[LabelKey, str, float]] = []
        for key, row in sorted(self._series.items()):
            for i, b in enumerate(self.buckets):
                le = "+Inf" if b == float("inf") else repr(b)
                out.append((key + (("le", le),), "_bucket", row[i]))
            out.append((key, "_sum", row[-2]))
            out.append((key, "_count", row[-1]))
        return out


class MetricsRegistry:
    """Registry of instruments + read-through sources.

    `register_source(prefix, fn)` is the migration mechanism for the
    repo's existing ledgers: `fn` returns the component's live
    counter dict (e.g. `server.counters`, `pool.counters`,
    `shard.stats`) and the registry reads it at snapshot time —
    `reconcile()` invariants and exported metrics therefore see the
    same numbers by construction, and the component's hot path never
    touches the registry."""

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 max_series_per_metric: int = DEFAULT_MAX_SERIES):
        self.clock = clock if clock is not None else time.monotonic
        self.max_series_per_metric = max_series_per_metric
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._sources: List[Tuple[str, Dict[str, str],
                                  Callable[[], Mapping[str, object]]]] = []
        self.dropped_series = 0

    # -- instrument constructors ------------------------------------------

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        name = _metric_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help, self, buckets=buckets)
                self._metrics[name] = m
            elif not isinstance(m, Histogram):
                raise TypeError(f"metric {name!r} already registered "
                                f"as {m.kind}")
            return m

    def _get_or_make(self, name: str, cls, help: str):
        name = _metric_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered "
                                f"as {m.kind}")
            return m

    # -- cardinality bound -------------------------------------------------

    def _admit(self, metric, key: LabelKey) -> LabelKey:
        """Admit a label-set to a metric, or collapse it into the
        overflow series when the metric is at its cardinality cap."""
        with self._lock:
            series = metric._series
            if key in series or len(series) < self.max_series_per_metric:
                return key
            self.dropped_series += 1
            return (("overflow", "true"),)

    # -- sources -----------------------------------------------------------

    def register_source(self, prefix: str,
                        fn: Callable[[], Mapping[str, object]],
                        labels: Optional[Mapping[str, str]] = None
                        ) -> None:
        """`fn()` is called at snapshot time; every numeric entry of
        the returned mapping becomes gauge `{prefix}_{key}` (bool ->
        0/1; None/str entries are skipped — see `sanitize_value`).
        A source that raises is skipped for that snapshot (a dying
        component must not take the exporter down with it)."""
        self._sources.append(
            (prefix, dict(labels or {}), fn))

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """One coherent read of everything: instruments + sources.
        Returns {"ts", "series": [{name, kind, labels, value}, ...],
        "dropped_series", "source_errors"}."""
        ts = self.clock()
        rows: List[Dict[str, object]] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for key, suffix, value in m._rows():
                rows.append({
                    "name": m.name + suffix,
                    "kind": m.kind,
                    "labels": dict(key),
                    "value": value,
                })
        source_errors = 0
        for prefix, labels, fn in list(self._sources):
            try:
                data = fn()
            except Exception:
                source_errors += 1
                continue
            for k in sorted(data):
                v = sanitize_value(data[k])
                if v is None:
                    continue
                rows.append({
                    "name": _metric_name(f"{prefix}_{k}"),
                    "kind": "gauge",
                    "labels": dict(labels),
                    "value": v,
                })
        rows.append({"name": "obs_dropped_series", "kind": "counter",
                     "labels": {}, "value": float(self.dropped_series)})
        return {"ts": ts, "series": rows,
                "dropped_series": self.dropped_series,
                "source_errors": source_errors}

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, grouped by metric."""
        snap = self.snapshot()
        by_name: Dict[str, List[Dict[str, object]]] = {}
        kinds: Dict[str, str] = {}
        for row in snap["series"]:
            base = row["name"]
            for suffix in ("_bucket", "_sum", "_count"):
                if row["kind"] == "histogram" and base.endswith(suffix):
                    base = base[: -len(suffix)]
                    break
            by_name.setdefault(base, []).append(row)
            kinds.setdefault(base, row["kind"])
        out: List[str] = []
        for base in sorted(by_name):
            out.append(f"# TYPE {base} {kinds[base]}")
            for row in by_name[base]:
                labels = row["labels"]
                if labels:
                    inner = ",".join(
                        f'{k}="{v}"' for k, v in sorted(labels.items()))
                    out.append(f"{row['name']}{{{inner}}} "
                               f"{_fmt(row['value'])}")
                else:
                    out.append(f"{row['name']} {_fmt(row['value'])}")
        return "\n".join(out) + "\n"

    def to_jsonl(self) -> str:
        """One JSON object per series (plus a trailing meta line) —
        the form bench stages embed and `--metrics-out` appends."""
        snap = self.snapshot()
        lines = [json.dumps({"ts": snap["ts"], **row}, sort_keys=True)
                 for row in snap["series"]]
        lines.append(json.dumps(
            {"ts": snap["ts"], "meta": {
                "dropped_series": snap["dropped_series"],
                "source_errors": snap["source_errors"]}},
            sort_keys=True))
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """Process-wide registry for call sites with no better scope
    (CLI, bench). Components under test should take an explicit
    registry instead — tests then never share state."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
