"""Flight recorder: last-N-events postmortem capture.

A fixed-size ring of recent spans and events, held in memory at
near-zero cost, dumped to disk only when something goes wrong — the
same shape as an aircraft FDR. Dump triggers (wired in by the
components, not here):

  - `ServingRouter._on_replica_death`  (ReplicaDeadError)
  - `ServingServer._native_fault`      (circuit breaker opens)
  - `ResilientTrainer._handle_bad_step` (divergence rollback)
  - SIGTERM drain paths (server + trainer)
  - `RecompileGuard` violations (the offending compile names land in
    the dump), via the lazy module-default hook below.

Dumps are colocated with the drain reports (`drain_report_path`'s
directory) and written tmp + `os.replace`, the repo's
crash-consistent file convention. `paddle_tpu obs dump <file>`
pretty-prints one.

Host-side only; injectable clock; never raises into the caller —
losing telemetry is always better than taking the server down.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

__all__ = ["FlightRecorder", "get_default", "peek_default",
           "set_default"]

DEFAULT_CAPACITY = 512


class FlightRecorder:
    """Ring buffer of {t, kind, name, ...} event dicts."""

    def __init__(self, *, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Callable[[], float]] = None):
        self.clock = clock if clock is not None else time.monotonic
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: Deque[Dict[str, object]] = collections.deque(
            maxlen=capacity)
        self.recorded = 0
        self.dumps = 0
        self.last_dump_path: Optional[str] = None
        self.last_dump_reason: Optional[str] = None

    # -- capture -----------------------------------------------------------

    def record(self, kind: str, name: str, **data: object) -> None:
        """Append one event. `data` must be JSON-serializable scalars
        / small containers — callers pass ids and counts, never
        arrays."""
        evt = {"t": self.clock(), "kind": kind, "name": name}
        if data:
            evt.update(data)
        with self._lock:
            self._ring.append(evt)
            self.recorded += 1

    def note_span(self, span) -> None:
        """Tracer sink: a finished span becomes one ring event (the
        natural `Tracer(sink=recorder.note_span)` wiring)."""
        try:
            d = span.to_dict()
        except Exception:
            return
        self.record("span", d.get("name", "?"), span=d)

    def events(self) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._ring)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"events": len(self._ring),
                    "recorded": self.recorded,
                    "dumps": self.dumps}

    # -- dump --------------------------------------------------------------

    def dump(self, path_or_dir: str, reason: str,
             extra: Optional[Dict[str, object]] = None
             ) -> Optional[str]:
        """Write the ring to disk. `path_or_dir` may be a directory
        (the drain-report dir — a `flight-<reason>-<n>.json` name is
        chosen inside it) or an exact file path. Returns the written
        path, or None when the write failed (never raises: the
        trigger sites are already handling a fault)."""
        try:
            with self._lock:
                events = list(self._ring)
                self.dumps += 1
                seq = self.dumps
            payload = {
                "kind": "flight_dump",
                "reason": reason,
                "t": self.clock(),
                "pid": os.getpid(),
                "n_events": len(events),
                "events": events,
            }
            if extra:
                payload["extra"] = extra
            if os.path.isdir(path_or_dir):
                safe = "".join(c if c.isalnum() or c in "-_" else "-"
                               for c in reason) or "dump"
                path = os.path.join(
                    path_or_dir,
                    f"flight-{safe}-{os.getpid()}-{seq}.json")
            else:
                path = path_or_dir
                parent = os.path.dirname(path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, default=str)
                f.write("\n")
            os.replace(tmp, path)
            self.last_dump_path = path
            self.last_dump_reason = reason
            return path
        except Exception:
            return None


# -- module default --------------------------------------------------------
#
# Components take an explicit recorder; the module default exists for
# call sites that cannot thread one through — principally
# `analysis.guards.RecompileGuard`, which lazy-imports this module so
# a steady-state recompile lands in whatever flight recorder the
# process has active, without `analysis` depending on `obs` at import
# time (no cycle).

_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def get_default() -> FlightRecorder:
    """The process-wide recorder, created on first use."""
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder()
        return _default


def peek_default() -> Optional[FlightRecorder]:
    """The process-wide recorder IF one exists — guard hooks use this
    so merely importing the guards never allocates obs state."""
    with _default_lock:
        return _default


def set_default(recorder: Optional[FlightRecorder]) -> None:
    """Install (or clear, with None) the process-wide recorder."""
    global _default
    with _default_lock:
        _default = recorder
