"""Lease-based membership with a single cluster epoch — the control
plane's source of truth for "which hosts exist".

The paper's v2 runtime delegated this to etcd: hosts registered
themselves under a lease, the master watched for key expiry, and a
host that stopped renewing simply VANISHED from the view. This module
is that service, self-hosted on the repo's own `wire.py` framing
(JSON payloads — control-plane traffic is tiny and debuggability
beats bytes here), with the three properties the chaos suites lean
on:

- **Leases, not liveness checks.** A host is in the view iff its
  lease (`cluster.lease.LeaseTable`, injectable clock) is unexpired.
  Host death is indistinguishable from host silence BY DESIGN — the
  eviction path is one path.

- **One monotonic cluster epoch.** EVERY view change (join, graceful
  leave, eviction batch, failover) bumps it. Views are retained per
  epoch so `wait_view(after_epoch)` delivers exactly one view per
  epoch, in order — a watcher can fold view changes without ever
  missing or double-seeing one.

- **Epoch-fenced writes.** Mutating requests carry the sender's
  believed epoch and its lease token. A write stamped with an epoch
  from before the sender's own registration — or from before the
  epoch that EVICTED it (tombstones remember) — is refused with
  ``stale_epoch``: a paused, partitioned, or resurrected agent can
  never mutate a cluster that has moved on. It must re-register,
  which is a visible join, not a silent write.

Replication reuses the pserver chain idiom (`native/pserver.py`
`_ReplLink`): every view-changing mutation ships a seq-stamped log
record to a warm standby; a gap or a lost link degrades to
rate-limited FULL-STATE resync offers rather than silently diverging.
`promote()` is the explicit failover: the standby resumes the epoch
sequence past the primary's last (failover itself is a view change)
and re-arms every lease with a fresh full TTL — hosts keep their
tokens and must simply renew against the new primary within one TTL.

Host-side only: no jax, no numpy.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from paddle_tpu_torch.cluster.lease import LeaseTable
from paddle_tpu_torch.wire import recv_frame, send_frame

__all__ = ["ClusterView", "MembershipClient", "MembershipServer",
           "MembershipService"]

log = logging.getLogger("paddle_tpu_torch.cluster")

#: request/response status strings (the wire is JSON; these are the
#: control plane's ST_* constants)
OK = "ok"
STALE_EPOCH = "stale_epoch"     # fenced: the sender's world ended
EXPIRED = "expired"             # lease/token gone: re-register
NEED_RESYNC = "need_resync"     # standby saw a seq gap
ERR = "err"


class ClusterView:
    """An immutable snapshot of the membership at one epoch."""

    __slots__ = ("epoch", "hosts")

    def __init__(self, epoch: int, hosts: Dict[str, dict]):
        self.epoch = epoch
        self.hosts = hosts

    def endpoints(self, kind: str) -> List[Tuple[str, Tuple[str, int]]]:
        """Flatten every host's inventory[kind] list of [host, port]
        endpoints into (host_id, (addr, port)) pairs, ordered by
        host_id then inventory order — a deterministic fleet roster
        any consumer can diff across epochs."""
        out: List[Tuple[str, Tuple[str, int]]] = []
        for host_id in sorted(self.hosts):
            for ep in self.hosts[host_id].get(kind, ()):
                out.append((host_id, (ep[0], int(ep[1]))))
        return out

    def to_json(self) -> dict:
        return {"epoch": self.epoch, "hosts": self.hosts}

    @classmethod
    def from_json(cls, d: dict) -> "ClusterView":
        return cls(int(d["epoch"]), dict(d["hosts"]))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ClusterView(epoch={self.epoch}, hosts={sorted(self.hosts)})"


class MembershipService:
    """The in-process membership state machine (the server wraps it
    in sockets; tests drive it directly).

    Expiry is EXPLICIT: leases only evict on `tick()`, which the
    fleet supervisor calls once per sweep (and chaos tests call by
    hand after advancing a `ManualClock`) — eviction timing is a
    caller decision, never a side effect of an unrelated request.
    """

    def __init__(self, *, default_ttl_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 max_views: int = 256,
                 primary: bool = True):
        self.clock = clock
        self.default_ttl_s = default_ttl_s
        self.max_views = max_views
        self.is_primary = primary
        self.leases = LeaseTable(default_ttl_s=default_ttl_s, clock=clock)
        self._lock = threading.Lock()
        self._changed = threading.Condition(self._lock)
        #: host_id -> {"token", "joined_epoch", "inventory"}
        self.hosts: Dict[str, dict] = {}
        #: host_id -> epoch of its LAST departure (the fence line a
        #: resurrected incarnation's stamps are judged against)
        self.evicted_at: Dict[str, int] = {}
        self.epoch = 0
        self.seq = 0                    # replication log position
        self._views: Dict[int, ClusterView] = {0: ClusterView(0, {})}
        self._standby: Optional["StandbyLink"] = None
        self.stats: Dict[str, int] = {
            "registers": 0, "renews": 0, "reports": 0, "evictions": 0,
            "deregisters": 0, "refused_stale_epoch": 0,
            "refused_expired": 0, "view_changes": 0, "shipped": 0,
            "ship_failures": 0, "resyncs": 0, "failovers": 0}

    # -- internal: views + replication (call under self._lock) -----------

    def _bump_view(self) -> None:  # locklint: holds-lock(every caller — register/report/deregister/tick/apply_entry/apply_snapshot/promote — invokes this inside `with self._lock`)
        self.epoch += 1
        self.stats["view_changes"] += 1
        hosts = {h: dict(rec["inventory"]) for h, rec in
                 self.hosts.items()}
        self._views[self.epoch] = ClusterView(self.epoch, hosts)
        while len(self._views) > self.max_views:
            del self._views[min(self._views)]
        self._changed.notify_all()

    def _log(self, kind: str, **args: Any) -> None:  # locklint: holds-lock(only called from state-changing ops inside `with self._lock`; ship order == apply order depends on it)
        """Append one replication record and ship it down the chain.
        Runs under the lock so the standby applies in exactly our
        order (the pserver `_replicate` contract)."""
        self.seq += 1
        if self._standby is None:
            return
        entry = {"seq": self.seq, "kind": kind, "args": args,
                 "epoch": self.epoch}
        if self._standby.ship(entry):
            self.stats["shipped"] += 1
        else:
            self.stats["ship_failures"] += 1
            # lost link: offer full state at a rate-limited cadence
            # (StandbyLink dedups the offers) — never increments over
            # a gap
            if self._standby.offer_resync(self._snapshot_locked()):
                self.stats["resyncs"] += 1

    def _snapshot_locked(self) -> dict:
        return {
            "epoch": self.epoch, "seq": self.seq,
            "hosts": {h: {"token": rec["token"],
                          "joined_epoch": rec["joined_epoch"],
                          "inventory": dict(rec["inventory"]),
                          "ttl_s": rec["ttl_s"]}
                      for h, rec in self.hosts.items()},
            "evicted_at": dict(self.evicted_at),
            "views": {str(e): v.to_json()
                      for e, v in self._views.items()},
        }

    def _fence(self, host_id: str, token: Optional[int],
               epoch: int) -> Optional[str]:
        """The write fence. Returns a refusal status or None (pass).
        Epoch checks FIRST: a stamp from a dead world is refused as
        stale even when the token also happens to be wrong — the
        refusal names the real reason the sender must not write."""
        if epoch > self.epoch:
            return STALE_EPOCH          # a future that never happened
        rec = self.hosts.get(host_id)
        if rec is None:
            gone_at = self.evicted_at.get(host_id)
            if gone_at is not None and epoch <= gone_at:
                return STALE_EPOCH      # your world ended at gone_at
            return EXPIRED              # unknown host: register first
        if epoch < rec["joined_epoch"]:
            return STALE_EPOCH          # stamp predates the CURRENT
        if token is not None and token != rec["token"]:
            return EXPIRED              # incarnation's registration
        return None

    # -- host-facing ops -------------------------------------------------

    def register(self, host_id: str, inventory: Optional[dict] = None,
                 ttl_s: Optional[float] = None) -> dict:
        """Join (or rejoin) the cluster. The ONE unfenced mutation —
        it is how a fenced host re-enters, and it is always a visible
        view change."""
        with self._lock:
            lease = self.leases.grant(host_id, ttl_s)
            self.hosts[host_id] = {
                "token": lease.token, "inventory": dict(inventory or {}),
                "joined_epoch": 0, "ttl_s": lease.ttl_s}
            self.evicted_at.pop(host_id, None)
            self.stats["registers"] += 1
            self._bump_view()
            self.hosts[host_id]["joined_epoch"] = self.epoch
            self._log("register", host_id=host_id, token=lease.token,
                      ttl_s=lease.ttl_s,
                      inventory=dict(inventory or {}),
                      joined_epoch=self.epoch)
            return {"status": OK, "token": lease.token,
                    "epoch": self.epoch, "ttl_s": lease.ttl_s}

    def renew(self, host_id: str, token: int, epoch: int) -> dict:
        """Heartbeat: extend the lease with its REGISTERED ttl. Not a
        view change (nothing moved), so not logged — the standby
        re-arms every lease at promote() instead of tracking each
        renewal."""
        with self._lock:
            refused = self._fence(host_id, token, epoch)
            if refused is None and not self.leases.renew(host_id, token):
                refused = EXPIRED       # past deadline, sweep pending
            if refused is not None:
                self.stats["refused_stale_epoch" if refused ==
                           STALE_EPOCH else "refused_expired"] += 1
                return {"status": refused, "epoch": self.epoch}
            self.stats["renews"] += 1
            return {"status": OK, "epoch": self.epoch}

    def report(self, host_id: str, token: int, epoch: int,
               inventory: dict) -> dict:
        """Replace the host's inventory (fenced write). An inventory
        change is a view change — consumers resolve endpoints from
        inventories, so they must see it as a new epoch."""
        with self._lock:
            refused = self._fence(host_id, token, epoch)
            if refused is not None:
                self.stats["refused_stale_epoch" if refused ==
                           STALE_EPOCH else "refused_expired"] += 1
                return {"status": refused, "epoch": self.epoch}
            self.leases.renew(host_id, token)   # a report proves life
            self.hosts[host_id]["inventory"] = dict(inventory)
            self.stats["reports"] += 1
            self._bump_view()
            self._log("report", host_id=host_id,
                      inventory=dict(inventory))
            return {"status": OK, "epoch": self.epoch}

    def deregister(self, host_id: str, token: int, epoch: int) -> dict:
        """Graceful leave (fenced): the host's own teardown path, so
        a planned departure doesn't burn a TTL of eviction latency."""
        with self._lock:
            refused = self._fence(host_id, token, epoch)
            if refused is not None:
                self.stats["refused_stale_epoch" if refused ==
                           STALE_EPOCH else "refused_expired"] += 1
                return {"status": refused, "epoch": self.epoch}
            del self.hosts[host_id]
            self.leases.revoke(host_id)
            self.stats["deregisters"] += 1
            self._bump_view()
            self.evicted_at[host_id] = self.epoch
            self._log("deregister", host_id=host_id)
            return {"status": OK, "epoch": self.epoch}

    # -- control ops -----------------------------------------------------

    def tick(self) -> List[str]:
        """Run lease expiry; a batch of simultaneous expiries is ONE
        view change (the survivors see one new world, not N
        intermediate ones). Returns the evicted host ids."""
        with self._lock:
            dead = [h for h in self.leases.expire() if h in self.hosts]
            if not dead:
                return []
            for h in dead:
                del self.hosts[h]
            self.stats["evictions"] += len(dead)
            self._bump_view()
            for h in dead:
                self.evicted_at[h] = self.epoch
            log.warning("membership: evicted %s -> epoch %d",
                        dead, self.epoch)
            self._log("evict", hosts=dead)
            return dead

    def view(self) -> ClusterView:
        with self._lock:
            return self._views[self.epoch]

    def wait_view(self, after_epoch: int,
                  timeout_s: float = 10.0) -> Optional[ClusterView]:
        """Block until a view NEWER than `after_epoch` exists, then
        return the oldest retained such view — called in a loop this
        yields exactly one view per epoch, in order. None on
        timeout. Waits on real time (watchers are remote pollers),
        independent of the lease clock."""
        deadline = time.monotonic() + timeout_s
        with self._changed:
            while self.epoch <= after_epoch:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._changed.wait(left)
            newer = [e for e in self._views if e > after_epoch]
            return self._views[min(newer)]

    def lease_margins(self) -> Dict[str, float]:
        """Per-host time-to-expiry (clock units; negative = past
        deadline, eviction pending the next tick). The chaos tests
        use this to wait until survivors have renewed past a manual
        clock jump before pulling the expiry trigger."""
        with self._lock:
            out = {}
            for h in self.hosts:
                m = self.leases.remaining(h)
                out[h] = float("-inf") if m is None else m
            return out

    # -- replication -----------------------------------------------------

    def attach_standby(self, link: "StandbyLink") -> None:
        with self._lock:
            self._standby = link
            # a fresh standby starts from a full snapshot, then rides
            # the incremental log
            if link.offer_resync(self._snapshot_locked(), force=True):
                self.stats["resyncs"] += 1

    def apply_entry(self, entry: dict) -> dict:
        """Standby side: apply one shipped record in order. A seq gap
        means records were lost — refuse with NEED_RESYNC rather than
        applying over the hole (the pserver `_h_repl` contract)."""
        with self._lock:
            seq = int(entry["seq"])
            if seq <= self.seq:
                return {"status": OK}           # dup of an old record
            if seq != self.seq + 1:
                return {"status": NEED_RESYNC}
            self.seq = seq
            kind, args = entry["kind"], entry["args"]
            if kind == "register":
                self.leases.install(args["host_id"], args["token"],
                                    args["ttl_s"])
                self.hosts[args["host_id"]] = {
                    "token": args["token"],
                    "joined_epoch": args["joined_epoch"],
                    "inventory": dict(args["inventory"]),
                    "ttl_s": args["ttl_s"]}
                self.evicted_at.pop(args["host_id"], None)
                self._bump_view()
            elif kind == "report":
                if args["host_id"] in self.hosts:
                    self.hosts[args["host_id"]]["inventory"] = (
                        dict(args["inventory"]))
                self._bump_view()
            elif kind in ("evict", "deregister"):
                dead = args.get("hosts", [args.get("host_id")])
                for h in dead:
                    self.hosts.pop(h, None)
                    self.leases.revoke(h)
                self._bump_view()
                for h in dead:
                    self.evicted_at[h] = self.epoch
            else:
                return {"status": ERR, "error": f"unknown kind {kind}"}
            return {"status": OK}

    def apply_snapshot(self, snap: dict) -> dict:
        """Standby side: adopt the primary's FULL state (initial sync
        or post-gap resync)."""
        with self._lock:
            self.epoch = int(snap["epoch"])
            self.seq = int(snap["seq"])
            self.hosts = {h: {"token": rec["token"],
                              "joined_epoch": rec["joined_epoch"],
                              "inventory": dict(rec["inventory"]),
                              "ttl_s": rec["ttl_s"]}
                          for h, rec in snap["hosts"].items()}
            self.evicted_at = dict(snap["evicted_at"])
            self._views = {int(e): ClusterView.from_json(v)
                           for e, v in snap["views"].items()}
            self.leases.clear()
            for h, rec in self.hosts.items():
                self.leases.install(h, rec["token"], rec["ttl_s"])
            self._changed.notify_all()
            return {"status": OK}

    def promote(self) -> dict:
        """Explicit failover: the standby becomes THE membership.
        Resumes the epoch sequence (failover is a view change — the
        epoch after promotion is strictly greater than any the old
        primary issued through this standby) and re-arms every lease
        with a fresh full TTL from the new primary's clock: hosts
        keep their tokens and simply renew here from now on."""
        with self._lock:
            self.is_primary = True
            for h, rec in self.hosts.items():
                lease = self.leases.get(h)
                if lease is None:
                    self.leases.install(h, rec["token"], rec["ttl_s"])
                else:
                    lease.deadline = self.clock() + rec["ttl_s"]
            self.stats["failovers"] += 1
            self._bump_view()
            return {"status": OK, "epoch": self.epoch}

    # -- observability ---------------------------------------------------

    def counters(self) -> Dict[str, float]:
        """Registry-source shaped: membership state + per-consumer
        lease stats + the hosts' own self-reported counters summed as
        ``agent_*`` (each agent folds {"counters": {...}} into its
        inventory)."""
        with self._lock:
            out: Dict[str, float] = dict(self.stats)
            out["epoch"] = self.epoch
            out["hosts_live"] = len(self.hosts)
            out["is_primary"] = int(self.is_primary)
            out["log_seq"] = self.seq
            for k, v in self.leases.stats.items():
                out[f"lease_{k}"] = v
            agg: Dict[str, float] = {}
            for rec in self.hosts.values():
                for k, v in rec["inventory"].get("counters",
                                                 {}).items():
                    if isinstance(v, (int, float)):
                        agg[f"agent_{k}"] = agg.get(f"agent_{k}", 0) + v
            out.update(agg)
            return out

    def bind_metrics(self, registry, *, prefix: str = "membership",
                     labels: Optional[dict] = None) -> None:
        registry.register_source(prefix, self.counters, labels=labels)


# -- the socket layer ----------------------------------------------------


class StandbyLink:
    """Primary-side link to the warm standby (the `_ReplLink` idiom):
    a persistent framed socket; any failure marks the link LOST and
    shipping stops — further increments over a gap would let the
    standby silently diverge. A lost link is offered the FULL state
    at a rate-limited cadence (`retry_s`) until one lands."""

    def __init__(self, addr: Tuple[str, int], *, timeout: float = 5.0,
                 retry_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.addr = addr
        self.timeout = timeout
        self.retry_s = retry_s
        self.clock = clock
        self.lost = False
        self._sock: Optional[socket.socket] = None
        self._last_offer = -float("inf")

    def _call(self, payload: dict) -> dict:
        if self._sock is None:
            self._sock = socket.create_connection(
                self.addr, timeout=self.timeout)
            self._sock.settimeout(self.timeout)
        send_frame(self._sock, json.dumps(payload).encode())
        return json.loads(recv_frame(self._sock).decode())

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def ship(self, entry: dict) -> bool:
        if self.lost:
            return False
        try:
            resp = self._call({"op": "ship", "entry": entry})
        except (OSError, ConnectionError, ValueError):
            self._drop()
            self.lost = True
            return False
        if resp.get("status") != OK:
            self.lost = True            # gap: standby needs a resync
            return False
        return True

    def offer_resync(self, snapshot: dict, *, force: bool = False) -> bool:
        now = self.clock()
        if not force and now - self._last_offer < self.retry_s:
            return False
        self._last_offer = now
        try:
            resp = self._call({"op": "sync_state", "snapshot": snapshot})
        except (OSError, ConnectionError, ValueError):
            self._drop()
            return False
        if resp.get("status") == OK:
            self.lost = False
            return True
        return False


class MembershipServer:
    """`MembershipService` behind a `wire.py`-framed TCP listener —
    one JSON request frame in, one JSON response frame out, a thread
    per connection (control-plane fan-in is a handful of agents and
    one supervisor)."""

    def __init__(self, service: MembershipService, *,
                 host: str = "127.0.0.1", port: int = 0,
                 conn_timeout: float = 30.0):
        self.service = service
        self.conn_timeout = conn_timeout
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.addr: Tuple[str, int] = self._listener.getsockname()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MembershipServer":
        self._thread = threading.Thread(
            target=self._accept_loop, name="membership-accept",
            daemon=True)
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.settimeout(self.conn_timeout)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    req = json.loads(recv_frame(conn).decode())
                except (ConnectionError, socket.timeout, OSError,
                        ValueError):
                    return
                try:
                    resp = self._dispatch(req)
                except Exception as e:      # report, keep serving
                    log.warning("membership request failed: %s", e)
                    resp = {"status": ERR, "error": str(e)}
                try:
                    send_frame(conn, json.dumps(resp).encode())
                except (ConnectionError, socket.timeout, OSError):
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, req: dict) -> dict:
        svc = self.service
        op = req.get("op")
        if op == "register":
            return svc.register(req["host_id"], req.get("inventory"),
                                req.get("ttl_s"))
        if op == "renew":
            return svc.renew(req["host_id"], req["token"], req["epoch"])
        if op == "report":
            return svc.report(req["host_id"], req["token"],
                              req["epoch"], req["inventory"])
        if op == "deregister":
            return svc.deregister(req["host_id"], req["token"],
                                  req["epoch"])
        if op == "view":
            return {"status": OK, "view": svc.view().to_json()}
        if op == "wait_view":
            v = svc.wait_view(req["after_epoch"],
                              req.get("timeout_s", 10.0))
            if v is None:
                return {"status": "timeout", "epoch": svc.epoch}
            return {"status": OK, "view": v.to_json()}
        if op == "tick":
            return {"status": OK, "evicted": svc.tick()}
        if op == "margins":
            return {"status": OK, "margins": svc.lease_margins()}
        if op == "counters":
            return {"status": OK, "counters": svc.counters()}
        if op == "ship":
            return svc.apply_entry(req["entry"])
        if op == "sync_state":
            return svc.apply_snapshot(req["snapshot"])
        if op == "promote":
            return svc.promote()
        if op == "ping":
            return {"status": OK, "epoch": svc.epoch,
                    "is_primary": int(svc.is_primary)}
        return {"status": ERR, "error": f"unknown op {op}"}

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass


class MembershipError(RuntimeError):
    """A membership op failed at the protocol level (refusals come
    back as status dicts, not exceptions — callers fence on those)."""


class MembershipClient:
    """Client over fresh-socket-per-call (control-plane rate is a few
    requests per second; a fresh connection per op means a primary
    restart or failover needs zero client-side connection repair —
    the next call simply dials the address it is given)."""

    def __init__(self, addr: Tuple[str, int], *,
                 connect_timeout: float = 5.0, io_timeout: float = 30.0):
        self.addr = (addr[0], int(addr[1]))
        self.connect_timeout = connect_timeout
        self.io_timeout = io_timeout

    def call(self, payload: dict, *,
             timeout_s: Optional[float] = None) -> dict:
        sock = socket.create_connection(
            self.addr, timeout=self.connect_timeout)
        try:
            sock.settimeout(timeout_s if timeout_s is not None
                            else self.io_timeout)
            send_frame(sock, json.dumps(payload).encode())
            resp = json.loads(recv_frame(sock).decode())
        finally:
            try:
                sock.close()
            except OSError:
                pass
        if resp.get("status") == ERR:
            raise MembershipError(resp.get("error", "membership error"))
        return resp

    # thin op wrappers ----------------------------------------------------

    def register(self, host_id: str, inventory: Optional[dict] = None,
                 ttl_s: Optional[float] = None) -> dict:
        return self.call({"op": "register", "host_id": host_id,
                          "inventory": inventory, "ttl_s": ttl_s})

    def renew(self, host_id: str, token: int, epoch: int) -> dict:
        return self.call({"op": "renew", "host_id": host_id,
                          "token": token, "epoch": epoch})

    def report(self, host_id: str, token: int, epoch: int,
               inventory: dict) -> dict:
        return self.call({"op": "report", "host_id": host_id,
                          "token": token, "epoch": epoch,
                          "inventory": inventory})

    def deregister(self, host_id: str, token: int, epoch: int) -> dict:
        return self.call({"op": "deregister", "host_id": host_id,
                          "token": token, "epoch": epoch})

    def view(self) -> ClusterView:
        return ClusterView.from_json(self.call({"op": "view"})["view"])

    def wait_view(self, after_epoch: int,
                  timeout_s: float = 10.0) -> Optional[ClusterView]:
        resp = self.call({"op": "wait_view", "after_epoch": after_epoch,
                          "timeout_s": timeout_s},
                         timeout_s=timeout_s + self.io_timeout)
        if resp["status"] != OK:
            return None
        return ClusterView.from_json(resp["view"])

    def tick(self) -> List[str]:
        return self.call({"op": "tick"})["evicted"]

    def lease_margins(self) -> Dict[str, float]:
        return self.call({"op": "margins"})["margins"]

    def counters(self) -> Dict[str, float]:
        return self.call({"op": "counters"})["counters"]

    def promote(self) -> dict:
        return self.call({"op": "promote"})

    def ping(self) -> dict:
        return self.call({"op": "ping"})
