"""The shared lease table — one expiry semantics, three consumers.

Before this module, the repo carried THREE lease/heartbeat
implementations with subtly drifting semantics: the pserver's trainer
leases (`native/pserver.py`, a `(token, deadline, ttl)` tuple dict),
the gang supervisor's heartbeat staleness (`parallel/launch.py`,
wall-clock deltas against atomic-file heartbeats), and now the
membership service's host leases. They share ONE definition here:

- **grant** assigns a monotonically increasing token (a grant is a
  new incarnation — a holder that re-registers gets a NEW token, so a
  zombie's old token can never pass for the replacement's).
- **renew** honours the TTL the holder REGISTERED with (the pserver
  chaos suite pins this: a short-lease trainer dies with its short
  lease even when the shard default is long).
- **expiry** is `now >= deadline` — a renewal processed exactly AT
  the deadline is already too late. Ties break toward eviction
  because the holder had the whole TTL to renew; "exactly on time"
  means its margin was zero, and a zero-margin holder is one
  scheduler hiccup away from split-brain.

The clock is injectable (`ManualClock` in tests, `time.monotonic` in
production) and expiry is EXPLICIT: nothing expires until `expire()`
runs, so a test can advance the clock, assert who WOULD die, and then
pull the trigger deterministically.

Host-side only: no jax, no numpy.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Hashable, List, Optional

__all__ = ["Lease", "LeaseTable"]


class Lease:
    """One live lease: the holder's token (its incarnation), the
    deadline (clock units), and the ttl renewals re-arm with."""

    __slots__ = ("key", "token", "ttl_s", "deadline")

    def __init__(self, key: Hashable, token: int, ttl_s: float,
                 deadline: float):
        self.key = key
        self.token = token
        self.ttl_s = ttl_s
        self.deadline = deadline

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Lease({self.key!r}, token={self.token}, "
                f"ttl={self.ttl_s}, deadline={self.deadline:.3f})")


class LeaseTable:
    """Grant/renew/expire bookkeeping over an injectable clock.

    Thread-safe (the pserver serves leases from per-connection
    threads; the membership server from its accept loop). Stats are
    registry-source shaped (numeric values only) so any consumer can
    fold them into its own counters.
    """

    def __init__(self, *, default_ttl_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if default_ttl_s <= 0:
            raise ValueError("default_ttl_s must be > 0")
        self.default_ttl_s = default_ttl_s
        self.clock = clock
        self._lock = threading.Lock()
        self._leases: Dict[Hashable, Lease] = {}
        self._next_token = 1
        self.stats: Dict[str, int] = {
            "granted": 0, "renewed": 0, "expired": 0, "revoked": 0,
            "refused_renewals": 0}

    # -- grant / renew ---------------------------------------------------

    def grant(self, key: Hashable,
              ttl_s: Optional[float] = None) -> Lease:
        """(Re-)grant a lease. A re-grant REPLACES the old
        incarnation: fresh token, fresh deadline — the previous
        token is dead from this moment."""
        ttl = ttl_s if ttl_s and ttl_s > 0 else self.default_ttl_s
        with self._lock:
            token = self._next_token
            self._next_token += 1
            lease = Lease(key, token, ttl, self.clock() + ttl)
            self._leases[key] = lease
            self.stats["granted"] += 1
            return lease

    def renew(self, key: Hashable, token: Optional[int] = None,
              ttl_s: Optional[float] = None) -> bool:
        """Extend a live lease. Refused (False) when the lease is
        gone, already past its deadline (the expiry-vs-renew race
        resolves toward EVICTION — `now >= deadline` loses), or the
        presented token is a stale incarnation. `ttl_s` overrides the
        re-arm interval for this renewal onward (the gang supervisor
        switches a member from its boot budget to the steady-state
        heartbeat ttl on the first observed heartbeat); by default
        the GRANTED ttl re-arms."""
        with self._lock:
            lease = self._leases.get(key)
            if lease is None:
                self.stats["refused_renewals"] += 1
                return False
            now = self.clock()
            if now >= lease.deadline:
                # dead on arrival: the expiry sweep just hasn't run
                # yet. Renewing it would resurrect a holder every
                # observer may already have declared dead.
                self.stats["refused_renewals"] += 1
                return False
            if token is not None and token != lease.token:
                self.stats["refused_renewals"] += 1
                return False
            if ttl_s and ttl_s > 0:
                lease.ttl_s = ttl_s
            lease.deadline = now + lease.ttl_s
            self.stats["renewed"] += 1
            return True

    def install(self, key: Hashable, token: int, ttl_s: float) -> Lease:
        """Adopt a lease granted ELSEWHERE (replication: the standby
        mirrors the primary's grants with the primary's tokens, so a
        host's credentials survive failover). Keeps the local token
        counter ahead so later local grants never collide."""
        with self._lock:
            lease = Lease(key, token, ttl_s, self.clock() + ttl_s)
            self._leases[key] = lease
            self._next_token = max(self._next_token, token + 1)
            return lease

    # -- expiry / queries ------------------------------------------------

    def expire(self) -> List[Hashable]:
        """Evict every lease past its deadline; returns the evicted
        keys (sorted for deterministic logs). Explicit — callers
        decide WHEN eviction happens, which is what makes manual-
        clock chaos tests deterministic."""
        with self._lock:
            now = self.clock()
            dead = sorted(k for k, l in self._leases.items()
                          if now >= l.deadline)
            for k in dead:
                del self._leases[k]
            self.stats["expired"] += len(dead)
            return dead

    def alive(self, key: Hashable,
              token: Optional[int] = None) -> bool:
        """Non-mutating liveness: lease present, deadline in the
        future, and (when given) the token matches the current
        incarnation."""
        with self._lock:
            lease = self._leases.get(key)
            if lease is None or self.clock() >= lease.deadline:
                return False
            return token is None or token == lease.token

    def get(self, key: Hashable) -> Optional[Lease]:
        with self._lock:
            return self._leases.get(key)

    def remaining(self, key: Hashable) -> Optional[float]:
        """Margin until expiry (negative = already past deadline but
        not yet swept). None when no lease exists."""
        with self._lock:
            lease = self._leases.get(key)
            if lease is None:
                return None
            return lease.deadline - self.clock()

    def revoke(self, key: Hashable) -> bool:
        """Drop a lease deliberately (graceful deregistration, a
        teardown) — distinct from expiry in the stats."""
        with self._lock:
            if key in self._leases:
                del self._leases[key]
                self.stats["revoked"] += 1
                return True
            return False

    def clear(self) -> None:
        with self._lock:
            self._leases.clear()

    def keys(self) -> List[Hashable]:
        with self._lock:
            return list(self._leases)

    def __len__(self) -> int:
        with self._lock:
            return len(self._leases)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._leases

    def __iter__(self):
        return iter(self.keys())
