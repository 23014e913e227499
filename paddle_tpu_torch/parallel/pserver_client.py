"""Trainer-side parameter-server client: failover, epochs, adapter
(port of `paddle_tpu.parallel.pserver_client`).

The counterpart of `native.pserver` (reference:
trainer/RemoteParameterUpdater.cpp + go/pserver/client — trainers talk
to every shard, pull touched rows, push sparse gradients, and survive
server death via etcd re-discovery; here the replacement discovery is
the `ShardSpec` endpoint list, primary first). Three layers:

- `ShardConn`: one shard's socket, hardened exactly like
  `native.MasterClient` — default timeout on every op, exponential
  backoff with seeded jitter, a fresh socket per attempt (a timeout
  mid-frame desyncs the framing; the old socket is never reused). On
  top of that: **failover** — a connection that cannot even be
  ESTABLISHED advances to the next endpoint (primary died → replica),
  while a mid-flight send/recv failure retries the SAME endpoint first
  (a lost ACK from a live server must be re-asked there, where the
  epoch watermark answers DUP).
- `PServerClient`: routes rows to owning shards by the `ShardSpec` row
  ranges (the `shard_rows` layout), numbers every push with a per-shard
  monotonic epoch so ANY retry — reconnect, failover, lost ACK — is
  applied exactly once server-side, and transparently re-registers when
  a push/finish lands on a server that never saw this trainer's lease
  (the failover target, or a server that expired us).
- `PServerEmbedding`: the swap-in adapter for the existing sparse call
  sites — same `init / lookup / apply_row_grads / alltoall_lookup /
  alltoall_push_row_grads` surface as `ShardedEmbedding` and
  `HostOffloadEmbedding`, with the table living server-side (the
  "table" argument is an opaque handle), so `ResilientTrainer` keeps
  training through a killed shard. Its lookups land on `device` (None
  means the card); the cache-backing methods stay host numpy.

The client and its wire format are the JAX module's byte for byte, so
the port's client talks to the JAX package's shards and the other way
round.
"""

from __future__ import annotations

import random as _random
import socket
import struct
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.native.pserver import (
    OP_FINISH_PASS,
    OP_GET_ROWS,
    OP_HEARTBEAT,
    OP_LOAD,
    OP_PASS_STATE,
    OP_PUSH,
    OP_REGISTER,
    OP_STATS,
    OP_WATERMARK,
    ST_DUP,
    ST_LEASE_EXPIRED,
    ST_OK,
    ShardSpec,
)
from paddle_tpu_torch.parallel.sparse import _normal_table
from paddle_tpu_torch.wire import recv_frame, send_frame


def _host(x) -> np.ndarray:
    """A host numpy view of ids, gradients or a learning rate (a tensor
    on any device, a numpy array or a Python number)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class PServerError(RuntimeError):
    """A shard answered with a server-side error (protocol misuse or an
    internal failure) — distinct from ConnectionError, which means no
    answer arrived at all."""


class ShardConn:
    """Failover socket client for ONE shard's endpoint chain.

    `call()` walks a bounded backoff schedule; endpoint choice is
    sticky (keep talking to whoever answered last). Failure handling
    follows where the failure happened:

    - connect refused/timeout: the endpoint is DOWN — advance to the
      next one immediately (primary → replica failover);
    - send/recv failure on an established connection: the server may be
      alive and may have APPLIED the op (lost ACK) — reconnect the SAME
      endpoint once so the retry lands where the epoch watermark can
      answer DUP; only if it cannot be re-established does the chain
      advance.

    Every pserver op is safe to retry through this path: reads are
    idempotent, pushes carry epochs (server dedupes), register re-grants
    and finish_pass re-marks.
    """

    def __init__(self, endpoints: Sequence[Tuple[str, int]], *,
                 timeout: float = 30.0, retries: int = 8,
                 backoff_base: float = 0.02, backoff_max: float = 1.0,
                 seed: Optional[int] = None):
        if not endpoints:
            raise ValueError("ShardConn needs at least one endpoint")
        self.endpoints = [tuple(e) for e in endpoints]
        self.timeout = timeout
        self.retries = retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self._rng = _random.Random(seed)
        self._active = 0
        self._sock: Optional[socket.socket] = None
        self._closed = False
        # failover ledger: bumped every time the chain advances to a
        # different endpoint. A caching reader snapshots this to learn
        # "the answering server may have changed" — the conservative
        # re-validate trigger (chain replication keeps a backup a
        # PREFIX of its primary, so a failover can legally rewind the
        # watermark; rows filled from the old primary must not be
        # trusted against the new authority).
        self.failovers = 0

    @property
    def active_endpoint(self) -> Tuple[str, int]:
        return self.endpoints[self._active]

    def _advance(self) -> None:
        self._active = (self._active + 1) % len(self.endpoints)
        self.failovers += 1

    def _connect(self) -> None:
        sock = socket.create_connection(self.active_endpoint,
                                        timeout=self.timeout)
        try:
            sock.settimeout(self.timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except BaseException:
            sock.close()
            raise
        self._sock = sock

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _backoff(self, attempt: int) -> float:
        ceiling = min(self.backoff_base * (2 ** attempt),
                      self.backoff_max)
        return self._rng.uniform(0, ceiling) or ceiling / 2

    def call(self, payload: bytes) -> bytes:
        if self._closed:
            raise RuntimeError("ShardConn is closed")
        last: Optional[BaseException] = None
        same_endpoint_retry = False
        ok = False
        try:
            for attempt in range(self.retries + 1):
                if attempt:
                    time.sleep(self._backoff(attempt - 1))
                try:
                    if self._sock is None:
                        self._connect()
                except (ConnectionError, socket.timeout, OSError) as e:
                    # endpoint down: fail over along the chain
                    last = e
                    self._advance()
                    same_endpoint_retry = False
                    continue
                try:
                    send_frame(self._sock, payload)
                    resp = recv_frame(self._sock)
                    ok = True
                    return resp
                except (ConnectionError, socket.timeout, OSError) as e:
                    last = e
                    self._drop()
                    # mid-flight failure: one fresh-socket retry on the
                    # SAME endpoint (lost-ACK / restarted server), then
                    # fail over
                    if same_endpoint_retry:
                        self._advance()
                        same_endpoint_retry = False
                    else:
                        same_endpoint_retry = True
        finally:
            if not ok:
                self._drop()
        raise ConnectionError(
            f"no pserver endpoint of {self.endpoints} answered after "
            f"{self.retries + 1} attempts: {last}") from last

    def update_endpoints(self,
                         endpoints: Sequence[Tuple[str, int]]) -> None:
        """Re-point the chain (membership topology refresh). The live
        socket drops so the next call dials the new chain from its
        head — primary first, per the inventory's ordering."""
        if not endpoints:
            raise ValueError("ShardConn needs at least one endpoint")
        self.endpoints = [tuple(e) for e in endpoints]
        self._active = 0
        self._drop()
        self.failovers += 1    # new chain == possibly-new authority

    def close(self) -> None:
        self._closed = True
        self._drop()


def shard_specs_from_view(view) -> List[ShardSpec]:
    """Resolve the pserver tier's `ShardSpec` list from a membership
    `ClusterView`: each serving host folds
    ``{"shards": [{"shard_id", "row_lo", "row_hi", "endpoints":
    [[host, port], ...], "role": "primary"|"backup"}, ...]}`` into its
    inventory, and this merges them per shard — primary endpoints
    first (the failover chain's head), then backups, each group in
    host_id order. The hardcoded-endpoint-list constructor stays for
    single-box runs; the multi-host path resolves HERE."""
    by_shard: dict = {}
    for host_id in sorted(view.hosts):
        for entry in view.hosts[host_id].get("shards", ()):
            rec = by_shard.setdefault(
                int(entry["shard_id"]),
                {"row_lo": int(entry["row_lo"]),
                 "row_hi": int(entry["row_hi"]),
                 "primary": [], "backup": []})
            if (rec["row_lo"], rec["row_hi"]) != (
                    int(entry["row_lo"]), int(entry["row_hi"])):
                raise ValueError(
                    f"hosts disagree on shard {entry['shard_id']} row "
                    f"range — a stale inventory is still registered")
            role = entry.get("role", "primary")
            eps = [(e[0], int(e[1])) for e in entry["endpoints"]]
            rec["backup" if role == "backup" else "primary"].extend(eps)
    specs = []
    for sid in sorted(by_shard):
        rec = by_shard[sid]
        endpoints = rec["primary"] + rec["backup"]
        if not endpoints:
            raise ValueError(f"shard {sid} has no endpoints in view")
        specs.append(ShardSpec(shard_id=sid, row_lo=rec["row_lo"],
                               row_hi=rec["row_hi"],
                               endpoints=endpoints))
    return specs


class PServerClient:
    """One trainer's connection fabric to every shard of a sparse table.

    `trainer_id` must be unique per trainer process — it keys both the
    lease and the exactly-once epoch watermark. Pushes are serialized
    per shard by `_lock` (the epoch order IS the apply order)."""

    def __init__(self, specs: Sequence[ShardSpec], dim: int, *,
                 trainer_id: int = 0,
                 lease_ttl_s: float = 30.0, timeout: float = 30.0,
                 retries: int = 8, backoff_base: float = 0.02,
                 backoff_max: float = 1.0, seed: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.dim = int(dim)
        specs = sorted(specs, key=lambda s: s.row_lo)
        for a, b in zip(specs, specs[1:]):
            if a.row_hi != b.row_lo:
                raise ValueError(
                    f"shard specs leave a row gap/overlap at "
                    f"[{a.row_hi}, {b.row_lo})")
        if not specs or specs[0].row_lo != 0:
            raise ValueError("shard specs must start at row 0")
        self.specs = specs
        self.num_rows = specs[-1].row_hi
        self.trainer_id = trainer_id
        self.lease_ttl_s = lease_ttl_s
        self._bounds = np.asarray([s.row_hi for s in specs], np.int64)
        self._conns = [ShardConn(s.endpoints, timeout=timeout,
                                 retries=retries,
                                 backoff_base=backoff_base,
                                 backoff_max=backoff_max,
                                 seed=None if seed is None else seed + i)
                       for i, s in enumerate(specs)]
        self._tokens: List[Optional[int]] = [None] * len(specs)
        self._epochs = [0] * len(specs)
        # last applied-update watermark each shard reported on ANY reply
        # (get_rows, push ACK, explicit probe) — the freshness ledger the
        # embed-cache invalidation protocol reads. A value can REGRESS
        # after failover (a backup is a prefix of its primary); consumers
        # of on_watermark must treat a rewind as "re-validate everything".
        self.watermarks = [0] * len(specs)
        # seam: fires as (shard, new_wm, prev_wm) after any reply carries
        # a watermark, inside the client lock — the subscriber (the
        # tiered cache) must only touch its own state, never call back
        # into this client
        self.on_watermark: Optional[Callable[[int, int, int], None]] = None
        # REENTRANT: every public RPC entry point takes it (the
        # heartbeat thread shares the per-shard sockets with the caller
        # — an unlocked send/recv pair would desync the framing), and
        # public methods compose (fetch_table -> get_rows)
        self._lock = threading.RLock()
        self.clock = clock
        self._last_hb = clock()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self.stats = {"pushes": 0, "duplicate_acks": 0,
                      "reregistrations": 0, "pulls": 0,
                      "watermark_polls": 0}
        # observability seam (the PagePool.obs_hook idiom): fires AFTER
        # an RPC settles, exceptions swallowed — ResilientTrainer points
        # this at the live step span so push/pull land on its trail.
        self.obs_hook: Optional[Callable] = None

    @classmethod
    def from_membership(cls, membership, dim: int,
                        **kw) -> "PServerClient":
        """Build a client whose shard topology comes from the
        membership view instead of a hardcoded endpoint list (the
        multi-host path). The membership handle is kept so
        `refresh_topology` can re-resolve after a view change."""
        client = cls(shard_specs_from_view(membership.view()), dim, **kw)
        client._membership = membership
        return client

    def refresh_topology(self) -> bool:
        """Re-resolve shard endpoints from the current membership view
        and re-point each shard's failover chain. The shard LAYOUT
        (count + row ranges) must be unchanged — rows don't move when a
        backup takes over, only endpoints do. Returns True if any
        chain actually changed. Raises RuntimeError when the client
        was not built via `from_membership`."""
        membership = getattr(self, "_membership", None)
        if membership is None:
            raise RuntimeError(
                "refresh_topology needs a membership-backed client "
                "(use PServerClient.from_membership)")
        fresh = shard_specs_from_view(membership.view())
        with self._lock:
            if [(s.shard_id, s.row_lo, s.row_hi) for s in fresh] != \
                    [(s.shard_id, s.row_lo, s.row_hi) for s in self.specs]:
                raise ValueError(
                    "membership view changed the shard layout; "
                    "rebuild the client instead of refreshing it")
            changed = False
            for i, spec in enumerate(fresh):
                if spec.endpoints != self._conns[i].endpoints:
                    self._conns[i].update_endpoints(spec.endpoints)
                    self.specs[i].endpoints = list(spec.endpoints)
                    changed = True
        if changed:
            self._obs("pserver.topology_refresh",
                      shards=len(fresh))
        return changed

    def _obs(self, event: str, **ctx) -> None:
        if self.obs_hook is None:
            return
        try:
            self.obs_hook(event, ctx)
        except Exception:
            pass

    def bind_metrics(self, registry, *, prefix: str = "pserver_client",
                     labels=None) -> None:
        """Register this client's exactly-once ledger as a read-through
        metrics source — exported numbers ARE the ledger."""
        registry.register_source(prefix, lambda: dict(self.stats),
                                 labels=labels)

    # -- leases ----------------------------------------------------------

    def register(self) -> None:
        with self._lock:
            for s in range(len(self.specs)):
                self._register_shard(s)

    # locklint: holds-lock(callers enter via public methods holding
    # the reentrant self._lock)
    def _register_shard(self, s: int) -> None:
        resp = self._conns[s].call(
            bytes([OP_REGISTER])
            + struct.pack("<qd", self.trainer_id, self.lease_ttl_s))
        self._check(resp, "register")
        token, _pass, watermark = struct.unpack_from("<QqQ", resp, 1)
        self._tokens[s] = token
        # adopt the server's applied-epoch watermark: a RESTARTED
        # trainer (fresh client, epochs at 0) must number its next push
        # PAST what the shard already applied, or every push until the
        # watermark would be silently DUP-discarded. max() keeps an
        # in-flight retried epoch valid on failover re-registration.
        self._epochs[s] = max(self._epochs[s], int(watermark))

    def heartbeat(self) -> None:
        """Renew every shard lease; a shard that no longer knows us
        (expired, or a failover target) gets a fresh registration."""
        with self._lock:
            for s in range(len(self.specs)):
                if self._tokens[s] is None:
                    self._register_shard(s)
                    continue
                resp = self._conns[s].call(
                    bytes([OP_HEARTBEAT])
                    + struct.pack("<qQ", self.trainer_id,
                                  self._tokens[s]))
                if resp[0] == ST_LEASE_EXPIRED:
                    self.stats["reregistrations"] += 1
                    self._register_shard(s)
                else:
                    self._check(resp, "heartbeat")
            self._last_hb = self.clock()

    def start_heartbeats(self, interval_s: float) -> None:
        if self._hb_thread is not None:
            return
        self._hb_stop.clear()

        def loop():
            while not self._hb_stop.wait(interval_s):
                try:
                    self.heartbeat()
                except (ConnectionError, PServerError):
                    pass    # next RPC surfaces a real outage

        self._hb_thread = threading.Thread(
            target=loop, name="pserver-heartbeat", daemon=True)
        self._hb_thread.start()

    # -- routing ---------------------------------------------------------

    def _owner_of(self, ids: np.ndarray) -> np.ndarray:
        """Owning-shard index per id; invalid ids map to -1 (zero rows
        on read, dropped on push — the padding-id contract shared with
        sharded_lookup / masked_row_delta)."""
        owner = np.searchsorted(self._bounds, ids, side="right")
        owner[(ids < 0) | (ids >= self.num_rows)] = -1
        return owner

    def owner_of(self, ids) -> np.ndarray:
        """Public routing map (the cache's shard-stamping entry point):
        [K] global ids -> [K] owning shard index, -1 for out-of-range."""
        return self._owner_of(
            np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64))

    @property
    def n_shards(self) -> int:
        return len(self.specs)

    # locklint: holds-lock(called from get_rows/_push_shard/
    # poll_watermarks under the reentrant self._lock)
    def _note_watermark(self, s: int, wm: int) -> None:
        prev = self.watermarks[s]
        self.watermarks[s] = wm
        hook = self.on_watermark
        if hook is not None and wm != prev:
            try:
                hook(s, wm, prev)
            except Exception:
                pass    # observability seam, never the data plane

    def shard_failovers(self) -> List[int]:
        """Per-shard count of chain advances (endpoint changes) so far —
        a caching reader diffs consecutive snapshots to detect "a
        different server may be answering now" and re-validates."""
        with self._lock:
            return [c.failovers for c in self._conns]

    def poll_watermarks(self) -> List[int]:
        """One OP_WATERMARK probe per shard: refresh the freshness
        ledger without moving any row bytes. This is the bounded-
        staleness heartbeat for an all-hit cache (misses and pushes
        refresh the ledger for free on their own replies)."""
        with self._lock:
            for s in range(len(self.specs)):
                resp = self._conns[s].call(bytes([OP_WATERMARK]))
                self._check(resp, "watermark")
                (wm,) = struct.unpack_from("<Q", resp, 1)
                self._note_watermark(s, int(wm))
            self.stats["watermark_polls"] += 1
            return list(self.watermarks)

    # -- data plane ------------------------------------------------------

    def get_rows(self, ids) -> np.ndarray:
        """[K] global ids -> [K, D] rows; out-of-range ids give ZERO
        vectors (sharded_lookup's contract)."""
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        dim = self.dim
        out = np.zeros((ids.shape[0], dim), np.float32)
        owner = self._owner_of(ids)
        with self._lock:
            for s in range(len(self.specs)):
                sel = np.flatnonzero(owner == s)
                if sel.size == 0:
                    continue
                sub = np.ascontiguousarray(ids[sel])
                resp = self._conns[s].call(
                    bytes([OP_GET_ROWS]) + struct.pack("<I", sub.size)
                    + sub.tobytes())
                self._check(resp, "get_rows")
                n, wm = struct.unpack_from("<IQ", resp, 1)
                rows = np.frombuffer(resp, np.float32, n * dim,
                                     offset=13).reshape(n, dim)
                out[sel] = rows
                self._note_watermark(s, int(wm))
            self.stats["pulls"] += 1
        self._obs("pserver_pull", rows=int(ids.shape[0]))
        return out

    def push_row_grads(self, ids, row_grads, lr: float) -> None:
        """Route sparse row gradients to their owning shards, exactly
        once each: every per-shard push gets the next epoch, and the
        retry loop (reconnect, failover, lost ACK) re-sends the SAME
        epoch until some replica ACKs — OK (applied now) and DUP
        (applied earlier, ACK lost) are both success."""
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        grads = np.ascontiguousarray(np.asarray(row_grads, np.float32))
        if grads.shape != (ids.shape[0], self.dim):
            raise ValueError(f"row_grads shape {grads.shape} != "
                             f"({ids.shape[0]}, {self.dim})")
        owner = self._owner_of(ids)
        with self._lock:
            for s in range(len(self.specs)):
                sel = np.flatnonzero(owner == s)
                if sel.size == 0:
                    continue
                self._epochs[s] += 1
                self._push_shard(s, self._epochs[s],
                                 np.ascontiguousarray(ids[sel]),
                                 np.ascontiguousarray(grads[sel]), lr)

    # locklint: holds-lock(called from push_row_grads/load_table
    # under the reentrant self._lock)
    def _push_shard(self, s: int, epoch: int, ids: np.ndarray,
                    grads: np.ndarray, lr: float) -> None:
        payload = (bytes([OP_PUSH])
                   + struct.pack("<qQdI", self.trainer_id, epoch, lr,
                                 ids.size)
                   + ids.tobytes() + grads.tobytes())
        while True:
            if self._tokens[s] is None:
                self._register_shard(s)
            resp = self._conns[s].call(payload)
            if resp[0] in (ST_OK, ST_DUP) and len(resp) >= 9:
                # push ACKs carry the post-apply shard watermark — the
                # pushing process's cache invalidates without a probe
                (wm,) = struct.unpack_from("<Q", resp, 1)
                self._note_watermark(s, int(wm))
            if resp[0] == ST_OK:
                self.stats["pushes"] += 1
                self._obs("pserver_push", shard=s, epoch=epoch,
                          rows=int(ids.size), outcome="ok")
                return
            if resp[0] == ST_DUP:
                # applied on an earlier attempt whose ACK was lost —
                # exactly-once held, count it for observability
                self.stats["duplicate_acks"] += 1
                self._obs("pserver_push", shard=s, epoch=epoch,
                          rows=int(ids.size), outcome="dup")
                return
            if resp[0] == ST_LEASE_EXPIRED:
                # the answering server (failover target, or one that
                # expired us) has no lease for this trainer: register
                # there and re-send the SAME epoch
                self.stats["reregistrations"] += 1
                self._tokens[s] = None
                continue
            self._check(resp, "push")

    # -- pass barrier ----------------------------------------------------

    def finish_pass(self, *, wait: bool = True, poll_s: float = 0.01,
                    timeout_s: float = 60.0) -> int:
        """Vote this trainer's pass finished on every shard; with
        `wait`, block until each shard's pass counter advances past its
        pre-vote value (all live-leased trainers finished — an expired
        peer is released by its lease, so a dead trainer cannot wedge
        this barrier). Returns the new pass number of shard 0.

        The poll loop does NOT hold the client lock between polls (the
        heartbeat thread must keep running under a long barrier) and
        renews this trainer's own leases every `lease_ttl_s / 3` while
        waiting — a waiting trainer must never expire out of the very
        barrier it is waiting on. A vote lives on the server that took
        it: if this shard's lease TOKEN changes mid-wait (failover to
        the replica, or an expiry + re-registration), the vote is gone
        there — the loop detects the token change and RE-VOTES on the
        now-active server, rebasing its target on that server's pass
        counter."""
        with self._lock:
            start = [self._finish_shard(s)
                     for s in range(len(self.specs))]
            vote_tokens = list(self._tokens)
        if not wait:
            return start[0][0] + (1 if start[0][1] else 0)
        deadline = self.clock() + timeout_s
        pass_nums = []
        for s, (before, done) in enumerate(start):
            target = before + 1
            current = before + 1 if done else before
            while current < target:
                if self.clock() > deadline:
                    raise TimeoutError(
                        f"pass barrier on shard {s} not reached in "
                        f"{timeout_s}s (pass {current} < {target})")
                time.sleep(poll_s)
                if (self.clock() - self._last_hb
                        > self.lease_ttl_s / 3):
                    self.heartbeat()
                with self._lock:
                    if self._tokens[s] != vote_tokens[s]:
                        # new lease => new server or fresh registration:
                        # our vote did not travel — re-assert it and
                        # rebase on that server's own counter
                        before, done = self._finish_shard(s)
                        vote_tokens[s] = self._tokens[s]
                        target = before + 1
                        current = before + 1 if done else before
                        continue
                current = self.pass_state(s)
            pass_nums.append(current)
        return pass_nums[0]

    def pass_state(self, s: int = 0) -> int:
        """Shard `s`'s current pass number (also ticks its lease-expiry
        sweep — any RPC does)."""
        with self._lock:
            resp = self._conns[s].call(bytes([OP_PASS_STATE]))
        self._check(resp, "pass_state")
        return struct.unpack_from("<q", resp, 1)[0]

    # locklint: holds-lock(called from finish_pass's locked poll loop)
    def _finish_shard(self, s: int) -> Tuple[int, bool]:
        while True:
            if self._tokens[s] is None:
                self._register_shard(s)
            resp = self._conns[s].call(
                bytes([OP_FINISH_PASS])
                + struct.pack("<qQ", self.trainer_id, self._tokens[s]))
            if resp[0] == ST_LEASE_EXPIRED:
                self.stats["reregistrations"] += 1
                self._tokens[s] = None
                continue
            self._check(resp, "finish_pass")
            pass_num, = struct.unpack_from("<q", resp, 1)
            done = bool(resp[9])
            # pass_num is POST-advance when done; report pre-vote base
            return (pass_num - 1, True) if done else (pass_num, False)

    # -- table init / dump ----------------------------------------------

    def load_table(self, table, *, chunk_rows: int = 8192) -> None:
        """SET the full table across shards (once-only init — the
        FinishInitParams analog). Idempotent; replicates to backups."""
        table = np.ascontiguousarray(np.asarray(table, np.float32))
        if table.shape != (self.num_rows, self.dim):
            raise ValueError(f"table shape {table.shape} != "
                             f"({self.num_rows}, {self.dim})")
        with self._lock:
            for s, spec in enumerate(self.specs):
                for lo in range(spec.row_lo, spec.row_hi, chunk_rows):
                    hi = min(lo + chunk_rows, spec.row_hi)
                    resp = self._conns[s].call(
                        bytes([OP_LOAD])
                        + struct.pack("<qI", lo, hi - lo)
                        + table[lo:hi].tobytes())
                    self._check(resp, "load")

    def fetch_table(self, *, chunk_rows: int = 8192) -> np.ndarray:
        """Assemble the full [num_rows, dim] table from the shards (for
        checks and exports — row traffic, not a hot path)."""
        out = np.zeros((self.num_rows, self.dim), np.float32)
        for lo in range(0, self.num_rows, chunk_rows):
            hi = min(lo + chunk_rows, self.num_rows)
            out[lo:hi] = self.get_rows(np.arange(lo, hi, dtype=np.int64))
        return out

    def shard_stats(self) -> List[dict]:
        import json

        stats = []
        with self._lock:
            for c in self._conns:
                resp = c.call(bytes([OP_STATS]))
                self._check(resp, "stats")
                stats.append(json.loads(resp[1:].decode()))
        return stats

    # -- plumbing --------------------------------------------------------

    @staticmethod
    def _check(resp: bytes, what: str) -> None:
        if not resp:
            raise PServerError(f"{what}: empty response")
        if resp[0] not in (ST_OK, ST_DUP):
            if resp[0] == ST_LEASE_EXPIRED:
                raise PServerError(f"{what}: lease expired (register "
                                   f"first)")
            raise PServerError(f"{what}: {resp[1:].decode(errors='replace')}")

    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None
        for c in self._conns:
            c.close()

    def __enter__(self) -> "PServerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PServerEmbedding:
    """Embedding adapter whose table lives on the parameter-server tier.

    Same call surface as `ShardedEmbedding`/`HostOffloadEmbedding`
    (init / lookup / apply_row_grads + the alltoall_* aliases the CTR
    call sites use), so it swaps into existing models: the dense update
    stays wherever it was (sharded on-chip), the sparse tail trains
    through `PServerClient` — and therefore through shard death,
    failover and retry, with exactly-once row updates.

    The `table` argument threaded through the surface is an opaque
    handle (the real rows are server-side); it is returned unchanged by
    the update ops so functional-style call sites keep composing.
    """

    class Handle:
        """Opaque stand-in for the on-device table."""

        def __init__(self, vocab: int, dim: int):
            self.shape = (vocab, dim)

        def __repr__(self):
            return f"PServerEmbedding.Handle{self.shape}"

    def __init__(self, client: PServerClient, *, init_scale: float = 0.01,
                 name: str = "pserver_embedding", device=None):
        self.client = client
        self.vocab = client.num_rows
        self.dim = client.dim
        self.init_scale = init_scale
        self.name = name
        self.device = resolve_device(device)

    def init(self, rng) -> "PServerEmbedding.Handle":
        """Draw the table host-side (a seed or a CPU torch.Generator, the
        HostOffloadEmbedding idiom — a pserver-scale table must never
        materialize in device memory) and LOAD it onto the shards;
        replication carries it to the backups."""
        table = _normal_table(rng, self.vocab, self.dim, self.init_scale)
        self.client.load_table(table.numpy())
        return PServerEmbedding.Handle(self.vocab, self.dim)

    def lookup(self, table, ids):
        """ids [K] -> [K, D] rows on the device; out-of-range ids (e.g.
        -1 padding) give ZERO vectors — the shared sparse-lookup
        contract. The rows cross to the card from a fresh pinned
        buffer, one copy a call."""
        rows = torch.from_numpy(self.client.get_rows(_host(ids)))
        if self.device.type == "cuda":
            return rows.pin_memory().to(self.device, non_blocking=True)
        return rows.to(self.device)

    def apply_row_grads(self, table, ids, row_grads, lr):
        self.client.push_row_grads(_host(ids), _host(row_grads),
                                   float(_host(lr)))
        return table

    # aliases matching the ShardedEmbedding call sites
    def alltoall_lookup(self, table, ids, *, capacity=None,
                        return_overflow: bool = False):
        out = self.lookup(table, ids)
        if return_overflow:
            return out, torch.zeros((), dtype=torch.int64,
                                    device=out.device)
        return out

    def alltoall_push_row_grads(self, table, ids, row_grads, lr, *,
                                capacity=None):
        return self.apply_row_grads(table, ids, row_grads, lr)

    # -- cache-backing surface (parallel.sparse.LookupSurface) ---------

    def pull_rows(self, table, ids):
        """Host-side read-through entry point for the tiered cache:
        [K] ids -> ([K, D] float32 host rows, per-shard watermark list
        as of each shard's reply). One RPC per owning shard per call —
        the batched miss-fill contract."""
        rows = self.client.get_rows(_host(ids))
        return rows, list(self.client.watermarks)

    def owner_of(self, ids) -> np.ndarray:
        return self.client.owner_of(ids)

    @property
    def n_shards(self) -> int:
        return self.client.n_shards

    def poll_watermarks(self, table):
        return self.client.poll_watermarks()

    def shard_failovers(self):
        return self.client.shard_failovers()
