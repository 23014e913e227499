"""Tiered hot-row embedding cache: the CTR serving read path (port of
`paddle_tpu.serve.embed_cache`).

The Paddle heritage serves CTR models whose embedding tables live on a
parameter-server tier (reference: pserver/ParameterServer2.h
getParameterSparse) — every inference-time lookup there pays a socket
round-trip per touched shard. This module is the read-through tier that
makes the hot set cheap without giving up freshness bounds:

- **Device tier**: a static ``[hot_rows + 1, dim]`` f32 arena resident
  on the card (a torch tensor) plus gather-by-slot indirection: a
  lookup is one ``index_select`` on the clamped slots, and a promotion
  one ``index_copy_`` of the new rows into their slots. The arena NEVER
  changes shape; slot vectors cross to the card from a fresh pinned
  buffer each (one host-to-device copy per lookup, never a row), and
  hot rows never re-cross PCIe.
- **Host tier**: a bounded LRU dict of every cached row (the device
  arena is strictly a replica of the hottest host entries), so a device
  eviction costs nothing and a host eviction of a device-resident row
  retires its slot too — one invariant, one source of truth.
- **Read-through**: misses and stale rows coalesce into ONE
  ``pull_rows`` call per lookup — the backing routes it as one ranged
  RPC per owning shard (never per row).

Freshness — the push-watermark invalidation protocol:

Every pserver shard keeps a monotonic applied-update counter
(``ShardState.version``) and now stamps it on every reply frame it
sends (get_rows, push ACK, the cheap OP_WATERMARK probe). The cache
records ``row -> watermark_seen`` at fill time and the latest known
per-shard watermark; a row is servable iff

    known_watermark[shard(row)] - watermark_seen[row] <= max_staleness

so a read NEVER serves a row staler than the configured bound relative
to everything the cache has learned. The ledger refreshes for free on
misses and on push ACKs (wire a pushing client's ``on_watermark`` seam
here via ``bind_push_feed``), and on demand via ``refresh()`` /
``refresh_every`` for all-hit steady states. Two conservative resets:

- **watermark rewind**: chain replication keeps a backup a PREFIX of
  its primary, so a failover may legally report a LOWER version; any
  rewind drops every cached row of that shard — degraded mode
  re-validates rather than serving rows the new authority never saw.
- **failover detection**: the client's per-shard failover counters
  (``shard_failovers``) are diffed on every lookup; any advance
  invalidates that shard even when the watermark happens to match.

The backing is anything exposing the `CacheBacking` surface —
`PServerEmbedding` (the production path) and `HostOffloadEmbedding`
(degenerate single-authority static mode, ``watermarks=None``) both do,
per the shared `parallel.sparse.LookupSurface` protocol; the cache
never isinstance-switches on it.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.devices import resolve_device


class CacheBacking(Protocol):
    """What a backing must expose to sit behind `TieredEmbedCache` —
    the read-through quintet shared by `PServerEmbedding` and
    `HostOffloadEmbedding` (structural, never isinstance-checked)."""

    vocab: int
    dim: int

    def pull_rows(self, table, ids) -> Tuple[np.ndarray,
                                             Optional[List[int]]]: ...

    def owner_of(self, ids) -> np.ndarray: ...

    @property
    def n_shards(self) -> int: ...

    def poll_watermarks(self, table) -> Optional[List[int]]: ...

    def shard_failovers(self) -> List[int]: ...


def _pad_width(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor): the gather's padded
    widths, as in the JAX cache (a handful of slot-vector sizes)."""
    w = floor
    while w < n:
        w *= 2
    return w


class TieredEmbedCache:
    """Two-tier read-through cache over a sharded embedding backing.

    `lookup(ids)` returns ``[K, dim]`` float32 ON DEVICE (`device`:
    None means the card, and raises without one) with the shared
    sparse-lookup contract (out-of-range ids -> zero vectors).
    `max_staleness` is in applied-update units: 0 means any push the
    cache has learned about invalidates the rows of that shard filled
    before it. `refresh_every=N` polls the per-shard watermarks every
    Nth lookup (the bounded-staleness heartbeat for all-hit phases);
    None leaves refreshes to misses, push feeds and explicit
    `refresh()` calls."""

    def __init__(self, backing: CacheBacking, table=None, *,
                 hot_rows: int = 1024, host_rows: int = 8192,
                 max_staleness: int = 0, fill_chunk: int = 64,
                 refresh_every: Optional[int] = None,
                 registry=None, prefix: str = "embed_cache",
                 labels=None,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        self.device = resolve_device(device)
        if hot_rows < 1:
            raise ValueError(f"hot_rows must be >= 1, got {hot_rows}")
        if host_rows < hot_rows:
            raise ValueError(
                f"host_rows ({host_rows}) must hold at least the device "
                f"tier ({hot_rows}): the arena replicates host entries")
        self.backing = backing
        self.table = table
        self.dim = int(backing.dim)
        self.hot_rows = int(hot_rows)
        self.host_rows = int(host_rows)
        self.max_staleness = int(max_staleness)
        self.fill_chunk = int(fill_chunk)
        self.refresh_every = refresh_every
        self.clock = clock
        # REENTRANT: note_watermark re-enters while lookup holds the
        # lock (a miss-fill's pull carries watermarks through the
        # client's on_watermark seam on this same thread)
        self._lock = threading.RLock()
        # host tier: row -> float32[dim], LRU order = recency
        self._host: "OrderedDict[int, np.ndarray]" = OrderedDict()
        # device tier: slot maps + its own LRU (a strict subset of host)
        self._slot_of: Dict[int, int] = {}
        self._dev_lru: "OrderedDict[int, None]" = OrderedDict()
        self._free_slots = list(range(self.hot_rows - 1, -1, -1))
        # freshness ledger
        self._row_wm: Dict[int, int] = {}
        self._shard_wm = [0] * int(backing.n_shards)
        self._failovers_seen = list(backing.shard_failovers())
        self._static = None  # unknown until the first pull answers
        # vectorized fast-path view of the device tier: sorted row ids
        # + aligned slots + per-shard min row-watermark, rebuilt lazily
        # whenever the tier mutates (see _fast_view_locked)
        self._fast_dirty = True
        self._fast_rows = np.empty(0, np.int64)
        self._fast_slots = np.empty(0, np.int64)
        self._fast_min_wm: Dict[int, int] = {}
        self._fast_unstamped = False
        self._stats: Dict[str, int] = {
            "lookups": 0, "rows_served": 0, "hits_device": 0,
            "hits_host": 0, "misses": 0, "stale_refills": 0,
            "pulls": 0, "rows_pulled": 0, "evictions_device": 0,
            "evictions_host": 0, "invalidations_failover": 0,
            "invalidations_rewind": 0, "watermark_polls": 0,
            "overflow_lookups": 0, "refresh_rows": 0,
        }
        # The arena carries ONE extra row (index hot_rows) that is
        # permanently zero: invalid/pad lookups index it directly, so
        # the gather needs no mask operand — one device transfer per
        # lookup (the slot vector), nothing else.
        self._arena = torch.zeros((self.hot_rows + 1, self.dim),
                                  dtype=torch.float32, device=self.device)
        if registry is not None:
            self.bind_metrics(registry, prefix=prefix, labels=labels)

    # -- observability ---------------------------------------------------

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats,
                        entries_device=len(self._slot_of),
                        entries_host=len(self._host))

    def bind_metrics(self, registry, *, prefix: str = "embed_cache",
                     labels=None) -> None:
        """Read-through source: the exported numbers ARE the ledger."""
        registry.register_source(prefix, self.counters, labels=labels)

    def watermarks(self) -> List[int]:
        with self._lock:
            return list(self._shard_wm)

    # -- invalidation protocol -------------------------------------------

    def note_watermark(self, shard: int, wm: int,
                       prev: Optional[int] = None) -> None:
        """Feed one shard's freshness ledger. Signature matches the
        `PServerClient.on_watermark` seam, so a pushing client wired
        via `bind_push_feed` invalidates this cache on every push ACK
        with zero extra RPCs. A REWIND (wm below what we knew) is the
        failover signature: drop the whole shard conservatively."""
        del prev  # the cache's own ledger is the comparison authority
        wm = int(wm)
        with self._lock:
            if shard >= len(self._shard_wm):
                return
            if wm < self._shard_wm[shard]:
                self._invalidate_shard_locked(shard)
                self._stats["invalidations_rewind"] += 1
            self._shard_wm[shard] = wm

    def bind_push_feed(self, client) -> None:
        """Point a `PServerClient`'s on_watermark seam at this cache:
        every push ACK that client receives advances the ledger here.

        Lock ordering: feed a DIFFERENT client than the one this cache
        reads through when the two run on different threads. The read
        path takes cache-lock then read-client-lock; a concurrent
        pusher on the SAME client would take client-lock then (via this
        seam) cache-lock — the classic AB-BA. Same-thread use (the
        read client's own push ACKs) is fine: both locks are
        reentrant."""
        client.on_watermark = self.note_watermark

    def refresh(self) -> Optional[List[int]]:
        """One cheap watermark probe per shard (no row bytes moved) —
        the explicit bounded-staleness heartbeat."""
        wms = self.backing.poll_watermarks(self.table)
        with self._lock:
            self._stats["watermark_polls"] += 1
            if wms is None:
                self._static = True
                return None
            self._static = False
            for s, wm in enumerate(wms):
                self.note_watermark(s, wm)
            return list(self._shard_wm)

    def refresh_stale(self) -> int:
        """Batched re-pull of every resident row the ledger marks stale
        — the MAINTENANCE loop's entry point. Production runs this off
        the request path (a background refresher ticking alongside the
        push feed), so steady-state lookups stay pure device gathers
        and the staleness bound is met by refreshing ahead of reads
        instead of refilling inside them. Returns the number of rows
        refreshed. The request path remains the enforcement authority:
        a stale row that sneaks past the refresher still refills in
        `lookup` before it is served."""
        with self._lock:
            if self._static or not self._host:
                return 0
            rows = np.fromiter(self._host.keys(), np.int64,
                               count=len(self._host))
            owners = self.backing.owner_of(rows)
            stale = [i for i in range(rows.size)
                     if owners[i] >= 0
                     and not self._fresh_locked(int(rows[i]),
                                                int(owners[i]))]
            if not stale:
                return 0
            sel = np.asarray(stale, np.int64)
            # its own counter, NOT stale_refills: a background refresh
            # is not a serve, and reconcile() audits serves only
            self._stats["refresh_rows"] += len(stale)
            self._fill_locked(rows[sel], owners[sel])
            self._promote_locked([int(r) for r in rows[sel]])
            # absorb the fast-view rebuild HERE, off the request path:
            # the next lookup then answers at pure gather cost instead
            # of paying the post-maintenance rebuild in its latency
            self._fast_view_locked()
            return len(stale)

    def invalidate_all(self) -> None:
        with self._lock:
            self._host.clear()
            self._slot_of.clear()
            self._dev_lru.clear()
            self._free_slots = list(range(self.hot_rows - 1, -1, -1))
            self._row_wm.clear()
            self._fast_dirty = True

    # locklint: holds-lock(callers hold the reentrant self._lock)
    def _invalidate_shard_locked(self, shard: int) -> None:
        if not self._host:
            return
        rows = np.fromiter(self._host.keys(), np.int64,
                           count=len(self._host))
        owners = self.backing.owner_of(rows)
        for r in rows[owners == shard]:
            self._drop_row_locked(int(r))

    # locklint: holds-lock(callers hold the reentrant self._lock)
    def _drop_row_locked(self, r: int) -> None:
        self._host.pop(r, None)
        self._row_wm.pop(r, None)
        slot = self._slot_of.pop(r, None)
        if slot is not None:
            self._dev_lru.pop(r, None)
            self._free_slots.append(slot)
            self._fast_dirty = True

    # locklint: holds-lock(callers hold the reentrant self._lock)
    def _check_failover_locked(self) -> None:
        now = self.backing.shard_failovers()
        for s, (seen, cur) in enumerate(zip(self._failovers_seen, now)):
            if cur != seen:
                self._invalidate_shard_locked(s)
                self._stats["invalidations_failover"] += 1
        self._failovers_seen = list(now)

    # -- the device tier ---------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """One explicit host-to-device copy. On the card it goes from a
        FRESH pinned buffer each call: reusing one buffer before its
        asynchronous copy has landed would serve another lookup's
        slots."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _gather(self, slots_np: np.ndarray) -> torch.Tensor:
        """[w] int32 slots -> [w, dim] arena rows (pads index the zero
        row at hot_rows)."""
        slots = self._to_device(slots_np).clamp_(0, self.hot_rows)
        return self._arena.index_select(0, slots)

    # -- the read path ---------------------------------------------------

    # locklint: holds-lock(called from lookup under the reentrant
    # self._lock)
    def _fresh_locked(self, r: int, owner: int) -> bool:
        if r not in self._host:
            return False
        if self._static:
            return True
        wm = self._row_wm.get(r)
        if wm is None:
            return False
        return self._shard_wm[owner] - wm <= self.max_staleness

    # locklint: holds-lock(called from lookup under the reentrant
    # self._lock)
    def _fill_locked(self, need: np.ndarray, owners: np.ndarray) -> None:
        """Batched miss-fill: ONE pull_rows call (one ranged RPC per
        owning shard inside the backing), then host-tier inserts
        stamped with each shard's reply watermark."""
        rows, wms = self.backing.pull_rows(self.table, need)
        self._stats["pulls"] += 1
        self._stats["rows_pulled"] += int(need.size)
        if wms is None:
            self._static = True
        else:
            self._static = False
            # only the shards this pull actually contacted report an
            # authoritative watermark: the backing's list keeps the
            # last-seen value for the others, which may lag a push
            # feed wired via bind_push_feed — stamping those would
            # read as spurious rewinds and invalidate healthy shards
            touched = {int(o) for o in owners}
            for s, wm in enumerate(wms):
                if s in touched:
                    # note_watermark handles the rewind reset BEFORE
                    # the rows below are stamped against the ledger
                    self.note_watermark(s, wm)
        for i, r in enumerate(need):
            r = int(r)
            self._host[r] = np.ascontiguousarray(rows[i], np.float32)
            self._host.move_to_end(r)
            # a refill of a device-resident row must retire its slot:
            # the arena copy is the STALE value — promotion below
            # re-scatters the fresh one
            slot = self._slot_of.pop(r, None)
            if slot is not None:
                self._dev_lru.pop(r, None)
                self._free_slots.append(slot)
                self._fast_dirty = True
            if wms is not None:
                self._row_wm[r] = self._shard_wm[int(owners[i])]
            while len(self._host) > self.host_rows:
                victim, _ = self._host.popitem(last=False)
                self._stats["evictions_host"] += 1
                # invariant: the arena replicates host entries only —
                # a host eviction retires the device slot too
                self._drop_row_locked(int(victim))

    # locklint: holds-lock(called from lookup under the reentrant
    # self._lock)
    def _promote_locked(self, rows_to_promote: List[int]) -> None:
        """Move host-tier rows into arena slots, `fill_chunk` rows per
        `index_copy_` (the JAX cache's chunks; its pad slots, which its
        scatter drops, are never built here, so the permanent zero row
        is never written)."""
        pending: List[Tuple[int, int]] = []   # (slot, row)
        for r in rows_to_promote:
            if r in self._slot_of or r not in self._host:
                continue
            if self._free_slots:
                slot = self._free_slots.pop()
            else:
                victim, _ = self._dev_lru.popitem(last=False)
                slot = self._slot_of.pop(victim)
                self._stats["evictions_device"] += 1
            self._slot_of[r] = slot
            self._dev_lru[r] = None
            pending.append((slot, r))
        if not pending:
            return
        self._fast_dirty = True
        # a slot taken twice in one call (its first row evicted again)
        # keeps only its last row: index_copy_ leaves duplicates' order
        # undefined
        last = {slot: i for i, (slot, _) in enumerate(pending)}
        pending = [p for i, p in enumerate(pending) if last[p[0]] == i]
        chunk = self.fill_chunk
        for lo in range(0, len(pending), chunk):
            part = pending[lo:lo + chunk]
            slots_np = np.fromiter((slot for slot, _ in part), np.int64,
                                   count=len(part))
            rows_np = np.stack([self._host[r] for _, r in part])
            self._arena.index_copy_(0, self._to_device(slots_np),
                                    self._to_device(rows_np))

    # locklint: holds-lock(called from lookup under the reentrant
    # self._lock)
    def _fast_view_locked(self) -> None:
        """Rebuild the vectorized device-tier view: sorted resident
        row ids, aligned slots, and the per-shard MINIMUM row
        watermark. The min is the whole-tier freshness proxy — if
        `shard_wm - min_wm <= max_staleness` holds per shard, EVERY
        device row of that shard is within bound, so the fast path can
        skip per-row checks entirely. Rebuilds only after mutations;
        steady state pays a dict-size fromiter + argsort once. The
        stamps are gathered with one C-level `map` and reduced per
        shard in numpy (the JAX cache walks the rows in Python: most of
        a Zipf request's time at 131072 resident rows)."""
        n = len(self._slot_of)
        rows = np.fromiter(self._slot_of.keys(), np.int64, count=n)
        slots = np.fromiter(self._slot_of.values(), np.int64, count=n)
        order = np.argsort(rows)
        self._fast_rows = rows[order]
        self._fast_slots = slots[order]
        self._fast_min_wm = {}
        self._fast_unstamped = False
        if not self._static and n:
            owners = np.asarray(self.backing.owner_of(self._fast_rows))
            # watermarks are applied-update counts (>= 0): -1 marks a
            # resident row with no stamp, which can never be proven
            # fresh — the view is unusable until it refills
            wms = np.fromiter(map(self._row_wm.get,
                                  self._fast_rows.tolist(),
                                  itertools.repeat(-1)), np.int64, count=n)
            self._fast_unstamped = bool((wms < 0).any())
            if not self._fast_unstamped:
                for o in np.unique(owners).tolist():
                    self._fast_min_wm[o] = int(wms[owners == o].min())
        self._fast_dirty = False

    # locklint: holds-lock(called from lookup under the reentrant
    # self._lock)
    def _fast_try_locked(self, ids: np.ndarray, k: int):
        """The all-resident steady-state answer: pure numpy
        classification (searchsorted against the sorted device view),
        one int32 slot transfer, one gather — no per-row Python.
        Returns None when ANY valid id is off-device or any shard's
        freshness proxy is out of bound; the slow path then classifies
        row by row. Device-LRU recency is NOT updated here (the fast
        path only fires when the whole request is resident, so there
        is no eviction pressure to order against). A request with a
        valid id off the device returns None before a dirty view is
        rebuilt (every None answer has no other effect, so the order of
        the checks is free): under traffic that keeps missing, the view
        is rebuilt only for requests that could take the fast path."""
        if self._fast_dirty:
            valid = ids[(ids >= 0) & (ids < self.backing.vocab)]
            if not all(map(self._slot_of.__contains__, valid.tolist())):
                return None
            self._fast_view_locked()
        if self._fast_rows.size == 0:
            return None
        if not self._static:
            if self._static is None or self._fast_unstamped:
                return None
            for o, wm in self._fast_min_wm.items():
                if self._shard_wm[o] - wm > self.max_staleness:
                    return None
        valid = (ids >= 0) & (ids < self.backing.vocab)
        idx = np.searchsorted(self._fast_rows, np.where(valid, ids, 0))
        idx_c = np.minimum(idx, self._fast_rows.size - 1)
        found = valid & (self._fast_rows[idx_c] == ids)
        if not np.array_equal(found, valid):
            return None
        nvalid = int(np.count_nonzero(valid))
        self._stats["rows_served"] += nvalid
        self._stats["hits_device"] += nvalid
        w = _pad_width(k)
        slots_np = np.full(w, self.hot_rows, np.int32)
        slots_np[:k] = np.where(found, self._fast_slots[idx_c],
                                self.hot_rows)
        return self._gather(slots_np)[:k]

    def lookup(self, ids):
        """[K] global ids -> [K, dim] float32 on device; out-of-range
        ids give zero vectors. Duplicates coalesce: each unique row is
        classified (and fetched) once per call."""
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        k = int(ids.shape[0])
        with self._lock:
            self._stats["lookups"] += 1
            if (self.refresh_every is not None
                    and self._stats["lookups"] % self.refresh_every == 0):
                self.refresh()
            self._check_failover_locked()
            fast = self._fast_try_locked(ids, k)
            if fast is not None:
                return fast
            uniq, inv = np.unique(ids, return_inverse=True)
            owners = self.backing.owner_of(uniq)
            valid = owners >= 0
            if self._static is None and np.any(valid):
                # first contact decides the freshness mode
                wms = self.backing.poll_watermarks(self.table)
                self._static = wms is None
                if wms is not None:
                    for s, wm in enumerate(wms):
                        self.note_watermark(s, wm)
            need_idx = []
            for i in np.flatnonzero(valid):
                r, o = int(uniq[i]), int(owners[i])
                if self._fresh_locked(r, o):
                    if r in self._slot_of:
                        self._stats["hits_device"] += 1
                        self._dev_lru.move_to_end(r)
                    else:
                        self._stats["hits_host"] += 1
                    self._host.move_to_end(r)
                else:
                    if r in self._host:
                        self._stats["stale_refills"] += 1
                    else:
                        self._stats["misses"] += 1
                    need_idx.append(i)
            self._stats["rows_served"] += int(np.count_nonzero(valid))
            if need_idx:
                sel = np.asarray(need_idx, np.int64)
                self._fill_locked(uniq[sel], owners[sel])
            live = [int(r) for i, r in enumerate(uniq)
                    if valid[i] and int(r) in self._host]
            if len(live) <= self.hot_rows:
                self._promote_locked(live)
            resident = all(r in self._slot_of for r in live)
            w = _pad_width(k)
            if resident:
                # invalid/pad positions point at the permanent zero
                # row (index hot_rows): one int32 transfer, no mask
                slots_np = np.full(w, self.hot_rows, np.int32)
                slot_u = np.full(uniq.shape[0], self.hot_rows, np.int64)
                for i, r in enumerate(uniq):
                    if valid[i]:
                        slot = self._slot_of.get(int(r))
                        if slot is not None:
                            slot_u[i] = slot
                slots_np[:k] = slot_u[inv]
                return self._gather(slots_np)[:k]
            # overflow: more live rows than the arena holds — serve
            # the whole batch from the host tier in one explicit copy
            self._stats["overflow_lookups"] += 1
            host_np = np.zeros((w, self.dim), np.float32)
            for j in range(k):
                r = int(ids[j])
                row = self._host.get(r)
                if row is not None:
                    host_np[j] = row
            return self._to_device(host_np[:k])

    # -- reconciliation ---------------------------------------------------

    def reconcile(self, shard_stats: Optional[List[dict]] = None) -> dict:
        """Audit the ledger against itself and (optionally) against the
        pserver push ledger: every served row must be accounted for by
        exactly one hit/miss/stale counter, and after a refresh the
        cache's per-shard watermark must equal each shard's applied-
        update `version` — the push ledger IS the invalidation feed."""
        with self._lock:
            c = dict(self._stats)
            out = {
                "serves_accounted": (
                    c["rows_served"] == c["hits_device"] + c["hits_host"]
                    + c["misses"] + c["stale_refills"]),
                "device_within_capacity":
                    len(self._slot_of) <= self.hot_rows,
                "host_within_capacity": len(self._host) <= self.host_rows,
                "device_subset_of_host":
                    all(r in self._host for r in self._slot_of),
            }
            if shard_stats is not None:
                out["watermarks_match_push_ledger"] = all(
                    self._shard_wm[s] == st.get("version")
                    for s, st in enumerate(shard_stats))
            out["ok"] = all(bool(v) for v in out.values())
            return out
