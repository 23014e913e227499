"""Fault-tolerant parameter-server runtime for sharded sparse tables.

The reference's third capability pillar: giant embedding tables live in
pserver HOST RAM, row-sharded across server processes, and trainers
pull/push only touched rows over the network (reference:
pserver/ParameterServer2.h:510 getParameterSparse / addGradient sparse
path; go/pserver/service.go gob checkpoints; go/pserver/etcd_client.go
registration leases). The TPU-native split this enables is the one
"Automatic Cross-Replica Sharding of Weight Update" motivates: the
dense update stays sharded on-chip (parallel.train_step), the sparse
tail lives here, in host RAM, behind the same reliability contract the
task-queue master already set (native.taskqueue):

- **wire protocol**: the MasterClient framing — 4-byte little-endian
  length prefix, then 1 opcode byte + body — so every hardening lesson
  (default socket timeouts, never reuse a desynced socket) carries
  over unchanged.
- **leases**: trainers register and heartbeat; an expired lease
  releases the trainer's in-flight pass so a dead trainer never wedges
  `finish_pass` for the survivors (the etcd-lease analog named in
  parallel/distributed.py). Mutating ops (push / finish_pass) require
  a live lease; reads do not.
- **exactly-once pushes**: every push carries (trainer_id, epoch); the
  shard remembers the last applied epoch per trainer and answers a
  replayed epoch with DUP instead of re-applying — so a client that
  lost the ACK retries the SAME epoch freely (the non-idempotent-op
  problem MasterClient.add_task can only refuse to retry, solved).
- **chain replication**: a primary forwards each applied update (and
  table load) to its backup and only ACKs the trainer after the backup
  applied it, in the same serialized order — the backup is therefore
  always a prefix-exact copy plus-or-minus the in-flight update, and a
  client that fails over mid-pass loses nothing and duplicates nothing
  (epochs replicate too, so the DUP check survives failover).
- **snapshots**: periodic atomic shard snapshots (local tmp +
  os.replace — the HAMaster idiom) so a restarted shard resumes from
  its last snapshot, then catches up by adopting its replica's state
  when the replica has seen more (version counter).

`parallel.pserver_client` is the trainer side; `testing.faults` injects
shard kill / lost ACK / slow replica / snapshot OSError through the
`fault_hook` seam; `tests/test_pserver.py` proves recovery end-to-end.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.cluster.lease import LeaseTable
from paddle_tpu_torch.wire import MAX_FRAME, recv_frame, send_frame
from paddle_tpu_torch.wire import recv_full as _recv_full

log = logging.getLogger(__name__)

# -- wire protocol (MasterClient framing: <I length, then payload) -------

OP_REGISTER = 1      # <q trainer_id, <d ttl_s
OP_HEARTBEAT = 2     # <q trainer_id, <Q token
OP_GET_ROWS = 3      # <I n, n * <q global row ids -> <IQ n wm, f32 rows
OP_PUSH = 4          # <q trainer, <Q epoch, <d lr, <I n, ids, f32 grads
OP_FINISH_PASS = 5   # <q trainer, <Q token
OP_PASS_STATE = 6    # -> <q pass_num, <B all_finished
OP_STATS = 7         # -> json
OP_LOAD = 8          # <q row_lo, <I n, f32 rows (SET — idempotent init)
OP_REPL = 9          # primary->backup: <B kind, <Q version, kind body
OP_SYNC = 10         # -> full shard state (restart catch-up)
OP_WATERMARK = 11    # -> <Q version (cheap staleness probe, no payload)

ST_OK = 0
ST_DUP = 1           # push epoch already applied — ACK without applying
ST_LEASE_EXPIRED = 2
ST_NEED_RESYNC = 3   # backup refusing an incremental over a version gap
ST_ERR = 255

_REPL_PUSH = 0
_REPL_LOAD = 1
_REPL_STATE = 2          # full-state resync after a degraded repl link

# Row traffic moves in bounded chunks, but SYNC / resync frames carry a
# whole shard's state — size shards below this (1 GiB ≈ 4M rows × 64
# f32 dims); anything larger is a protocol error, not a workload.
_MAX_FRAME = MAX_FRAME


class FaultSignal(Exception):
    """Base of the exceptions a fault_hook may raise to steer the shard
    (testing.faults uses these; they are part of the test seam, not the
    public error surface)."""


class KillShard(FaultSignal):
    """Abrupt shard death before the current op completes: listener and
    every connection close, no reply is sent."""


class DropConnection(FaultSignal):
    """Close the current connection without replying (the lost-ACK
    shape) — the shard itself stays alive."""


# The framing itself (4-byte-LE prefix, bounded-before-allocation,
# EINTR/short-read-safe loops) lives in `paddle_tpu_torch.wire` — shared
# with the trainer-side shard client and the serving fleet's replica
# transport, re-exported here for the existing call sites.


# -- shard state ---------------------------------------------------------


class ShardState:
    """The host-RAM row range one shard owns, plus the two pieces of
    metadata the reliability contract needs: per-trainer applied-epoch
    watermarks (exactly-once) and a version counter (replica
    catch-up ordering)."""

    def __init__(self, row_lo: int, row_hi: int, dim: int,
                 dtype=np.float32):
        if not (0 <= row_lo < row_hi):
            raise ValueError(f"bad row range [{row_lo}, {row_hi})")
        self.row_lo = row_lo
        self.row_hi = row_hi
        self.dim = dim
        self.rows = np.zeros((row_hi - row_lo, dim), dtype)
        self.version = 0                      # applied updates, in order
        self.epochs: Dict[int, int] = {}      # trainer -> last epoch

    def apply_push(self, trainer: int, epoch: int, ids: np.ndarray,
                   grads: np.ndarray, lr: float) -> bool:
        """Apply -lr * grads to the owned rows among `ids` (global).
        Returns False — without touching anything — when this trainer's
        epoch was already applied (the retried-push-after-lost-ACK
        case). Duplicate ids WITHIN one push accumulate, matching
        rowwise_sgd_update / SelectedRows semantics."""
        if epoch <= self.epochs.get(trainer, 0):
            return False
        local = ids - self.row_lo
        ok = (ids >= self.row_lo) & (ids < self.row_hi)
        np.add.at(self.rows, local[ok],
                  (-lr * grads[ok]).astype(self.rows.dtype))
        self.epochs[trainer] = epoch
        self.version += 1
        return True

    def apply_load(self, row_lo: int, values: np.ndarray) -> None:
        """SET a row range (table init / state transfer) — idempotent,
        unlike push."""
        lo = row_lo - self.row_lo
        if lo < 0 or lo + values.shape[0] > self.rows.shape[0]:
            raise ValueError(
                f"load [{row_lo}, {row_lo + values.shape[0]}) outside "
                f"owned [{self.row_lo}, {self.row_hi})")
        self.rows[lo: lo + values.shape[0]] = values
        self.version += 1

    def take_rows(self, ids: np.ndarray) -> np.ndarray:
        """Owned rows for `ids` (global); rows this shard does not own
        come back ZERO — the caller sums/assembles across shards, the
        same contract as sharded_lookup."""
        local = ids - self.row_lo
        ok = (ids >= self.row_lo) & (ids < self.row_hi)
        out = np.zeros((ids.shape[0], self.dim), self.rows.dtype)
        out[ok] = self.rows[local[ok]]
        return out

    # -- snapshot / restore (HAMaster idiom: tmp + os.replace) ----------

    def save(self, path: str) -> None:
        d = os.path.dirname(path) or "."
        fd, tmp = tempfile.mkstemp(prefix=".pshard-", suffix=".tmp",
                                   dir=d)
        os.close(fd)
        try:
            ek = np.asarray(sorted(self.epochs), np.int64)
            ev = np.asarray([self.epochs[k] for k in sorted(self.epochs)],
                            np.int64)
            with open(tmp, "wb") as f:
                np.savez(f, rows=self.rows,
                         version=np.int64(self.version),
                         row_lo=np.int64(self.row_lo),
                         row_hi=np.int64(self.row_hi),
                         epoch_keys=ek, epoch_vals=ev)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def load(cls, path: str, dim: int) -> "ShardState":
        with np.load(path) as z:
            st = cls(int(z["row_lo"]), int(z["row_hi"]), dim)
            rows = z["rows"]
            if rows.shape != st.rows.shape:
                raise ValueError(
                    f"{path}: snapshot shape {rows.shape} != owned "
                    f"{st.rows.shape}")
            st.rows = rows.copy()
            st.version = int(z["version"])
            st.epochs = {int(k): int(v) for k, v in
                         zip(z["epoch_keys"], z["epoch_vals"])}
        return st

    def adopt(self, other: "ShardState") -> None:
        """Take another replica's state wholesale (catch-up after a
        restart when the peer has seen more updates)."""
        if (other.row_lo, other.row_hi) != (self.row_lo, self.row_hi):
            raise ValueError("cannot adopt state for a different range")
        self.rows = other.rows.copy()
        self.version = other.version
        self.epochs = dict(other.epochs)


# -- replication link (primary -> backup) --------------------------------


class _ReplLink:
    """Primary's connection to its backup. One reconnect attempt per
    send; a backup that stays unreachable degrades the pair to
    unreplicated-but-available (`lost` flips True, visible in stats and
    logs) rather than blocking every trainer push forever."""

    def __init__(self, addr: Tuple[str, int], *, timeout: float = 10.0):
        self.addr = addr
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self.lost = False
        self.last_resync_attempt = float("-inf")

    def _connect(self) -> None:
        sock = socket.create_connection(self.addr, timeout=self.timeout)
        try:
            sock.settimeout(self.timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except BaseException:
            sock.close()
            raise
        self._sock = sock

    def send(self, payload: bytes) -> bool:
        """Deliver one replication record; True when the backup ACKed.
        ANY other outcome — unreachable, timeout, or a non-OK reply —
        marks the link `lost`: the backup may now have a gap, and the
        primary must full-state resync before trusting it again."""
        for _ in range(2):
            try:
                if self._sock is None:
                    self._connect()
                send_frame(self._sock, payload)
                resp = recv_frame(self._sock)
                if resp and resp[0] == ST_OK:
                    self.lost = False
                    return True
                log.warning("pserver replica %s rejected a replication "
                            "record — marking the link lost for resync",
                            self.addr)
                self.lost = True
                return False
            except (ConnectionError, socket.timeout, OSError):
                self.close()
        if not self.lost:
            log.warning("pserver replica %s unreachable — pair degraded "
                        "to unreplicated until it answers again",
                        self.addr)
        self.lost = True
        return False

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


# -- the shard service ---------------------------------------------------


class PServerShard:
    """One parameter-server shard: a host-RAM row range behind a TCP
    service, with leases, exactly-once push epochs, chain replication
    to an optional backup, and atomic snapshots.

    `clock` is injectable (lease tests advance a manual clock instead of
    sleeping); `fault_hook(event)` is the testing.faults seam, called at
    "push_recv" (before apply), "push_pre_ack" (applied + replicated,
    reply not yet sent), "repl_apply" (backup, before applying a
    replicated record), and "snapshot" (before writing).
    """

    def __init__(self, shard_id: int, row_lo: int, row_hi: int, dim: int,
                 *, port: int = 0, host: str = "127.0.0.1",
                 name: Optional[str] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_interval_s: float = 0.0,
                 replica_addr: Optional[Tuple[str, int]] = None,
                 sync_from: Optional[Tuple[str, int]] = None,
                 lease_ttl_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 conn_timeout: float = 30.0,
                 repl_retry_s: float = 1.0,
                 fault_hook: Optional[Callable[[str], None]] = None):
        self.shard_id = shard_id
        self.name = name or f"shard-{shard_id}"
        self.state = ShardState(row_lo, row_hi, dim)
        self.snapshot_dir = snapshot_dir
        self.lease_ttl_s = lease_ttl_s
        self.clock = clock
        self.conn_timeout = conn_timeout
        self.repl_retry_s = repl_retry_s
        self.fault_hook = fault_hook
        self.restored_from: Optional[str] = None
        self.synced_from_peer = False
        self.catchup_error: Optional[str] = None
        self.last_snapshot_error: Optional[str] = None
        self.killed = False
        self._lock = threading.Lock()
        # trainer leases: the shared cluster.lease table (renewals use
        # the TTL the trainer REGISTERED with, not the shard default —
        # LeaseTable's renew contract)
        self._leases = LeaseTable(default_ttl_s=lease_ttl_s, clock=clock)
        self._pass_num = 0
        self._pass_finished: set = set()
        self._stats = {"pushes": 0, "duplicates": 0, "gets": 0,
                       "probes": 0, "lease_expirations": 0,
                       "repl_records": 0, "repl_resyncs": 0}
        if snapshot_dir:
            os.makedirs(snapshot_dir, exist_ok=True)
            snap = self.snapshot_path
            if os.path.exists(snap):
                self.state = ShardState.load(snap, dim)
                self.restored_from = snap
        if sync_from is not None:
            self._catch_up(sync_from)
        # the repl link gets a SHORTER timeout than trainer conns: its
        # I/O runs under the shard lock, so a blackholed backup must
        # cost a short bounded stall (then degrade + rate-limited
        # resync probes), not conn_timeout per attempt for everyone
        self._repl = (_ReplLink(replica_addr,
                                timeout=min(conn_timeout, 5.0))
                      if replica_addr else None)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.addr: Tuple[str, int] = self._listener.getsockname()
        self._conns: set = set()
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"pserver-{self.name}",
            daemon=True)
        self._accept_thread.start()
        self._snap_thread = None
        if snapshot_dir and snapshot_interval_s > 0:
            self._snap_thread = threading.Thread(
                target=self._snap_loop, args=(snapshot_interval_s,),
                name=f"pserver-{self.name}-snap", daemon=True)
            self._snap_thread.start()

    # -- lifecycle -------------------------------------------------------

    @property
    def snapshot_path(self) -> Optional[str]:
        if not self.snapshot_dir:
            return None
        return os.path.join(self.snapshot_dir, f"{self.name}.npz")

    def _catch_up(self, peer: Tuple[str, int]) -> None:
        """Adopt the peer replica's state when it has seen more updates
        than our snapshot (the restarted shard resumes from snapshot
        PLUS replica catch-up). An unreachable peer is tolerated — we
        may BE the first one up — but any OTHER failure is logged and
        kept in `catchup_error`: coming up on a stale snapshot must be
        a visible degradation, never a silent one."""
        self.catchup_error: Optional[str] = None
        try:
            sock = socket.create_connection(peer, timeout=self.conn_timeout)
        except OSError:
            return      # no peer up: nothing to catch up FROM
        try:
            sock.settimeout(self.conn_timeout)
            send_frame(sock, bytes([OP_SYNC]))
            resp = recv_frame(sock)
        except (ConnectionError, socket.timeout, OSError) as e:
            self.catchup_error = str(e)
            log.warning(
                "pserver %s: catch-up sync from %s failed (%s) — "
                "serving from the local snapshot, which may be STALE",
                self.name, peer, e)
            return
        finally:
            sock.close()
        if not resp or resp[0] != ST_OK:
            self.catchup_error = "peer refused sync"
            log.warning("pserver %s: peer %s refused catch-up sync",
                        self.name, peer)
            return
        peer_state = _decode_sync(resp, self.state.dim)
        if peer_state.version > self.state.version:
            self.state.adopt(peer_state)
            self.synced_from_peer = True

    def kill(self) -> None:
        """Abrupt death (the fault path): close the listener and every
        live connection NOW; in-flight requests never get replies.
        Connections are RST (SO_LINGER 0), not FIN'd — a crashed
        process doesn't shut down politely, and a lingering FIN_WAIT
        socket would block an immediate restart on the same port."""
        self.killed = True
        self._stop.set()
        # shutdown BEFORE close: close() alone does not unblock a
        # thread sitting in accept() — the kernel keeps the listening
        # socket alive (port still bound, no owner) until that syscall
        # returns; shutdown wakes it with an error so the port frees
        # deterministically for an in-place restart
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._repl is not None:
            self._repl.close()

    def stop(self, *, final_snapshot: bool = True) -> None:
        """Graceful shutdown: one last snapshot, then close."""
        if final_snapshot and self.snapshot_dir and not self.killed:
            try:
                self.snapshot()
            except OSError:
                pass
        self.kill()
        self.killed = False      # a stopped shard is not a "dead" one

    def __enter__(self) -> "PServerShard":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- snapshots -------------------------------------------------------

    def snapshot(self) -> str:
        """Write one atomic snapshot now (under the state lock: the
        npz is a consistent point-in-time cut, never a torn mix of two
        pushes)."""
        path = self.snapshot_path
        if path is None:
            raise ValueError(f"{self.name}: no snapshot_dir configured")
        with self._lock:
            try:
                self._fault("snapshot")
                self.state.save(path)
            except OSError as e:
                self.last_snapshot_error = str(e)
                raise
            self.last_snapshot_error = None
        return path

    def _snap_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.snapshot()
            except OSError as e:
                log.warning("pserver %s snapshot failed: %s", self.name, e)

    # -- leases ----------------------------------------------------------

    # locklint: holds-lock(called from _dispatch inside its
    # `with self._lock:` block)
    def _expire_leases(self) -> None:
        for t in self._leases.expire():
            # an expired lease releases the trainer's in-flight
            # pass: it stops counting toward the finish barrier so
            # the survivors' pass can complete
            self._pass_finished.discard(t)
            self._stats["lease_expirations"] += 1
            log.warning("pserver %s: trainer %d lease expired — "
                        "released from pass %d", self.name, t,
                        self._pass_num)
        self._check_pass_done()

    def _lease_ok(self, trainer: int, token: int) -> bool:
        lease = self._leases.get(trainer)
        return lease is not None and lease.token == token

    # locklint: holds-lock(both callers — _expire_leases and
    # _h_finish_pass — run inside _dispatch's `with self._lock:` block)
    def _check_pass_done(self) -> None:
        if self._leases and self._pass_finished >= set(self._leases):
            self._pass_num += 1
            self._pass_finished.clear()

    # -- service loop ----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.settimeout(self.conn_timeout)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    req = recv_frame(conn)
                except (ConnectionError, socket.timeout, OSError):
                    return
                try:
                    resp = self._dispatch(req)
                except KillShard:
                    self.kill()
                    return
                except DropConnection:
                    return
                except Exception as e:   # protocol/user error: report,
                    log.warning("pserver %s request failed: %s",
                                self.name, e)
                    resp = bytes([ST_ERR]) + str(e).encode()
                try:
                    send_frame(conn, resp)
                except (ConnectionError, socket.timeout, OSError):
                    return
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _fault(self, event: str) -> None:
        hook = self.fault_hook
        if hook is not None:
            hook(event)

    # -- request handlers ------------------------------------------------

    def _dispatch(self, req: bytes) -> bytes:
        op = req[0]
        body = req[1:]
        with self._lock:
            self._expire_leases()
            if op == OP_REGISTER:
                return self._h_register(body)
            if op == OP_HEARTBEAT:
                return self._h_heartbeat(body)
            if op == OP_GET_ROWS:
                return self._h_get_rows(body)
            if op == OP_PUSH:
                return self._h_push(body)
            if op == OP_FINISH_PASS:
                return self._h_finish_pass(body)
            if op == OP_PASS_STATE:
                return (bytes([ST_OK])
                        + struct.pack("<q", self._pass_num)
                        + struct.pack("<B", not self._pass_finished))
            if op == OP_STATS:
                return bytes([ST_OK]) + json.dumps(self.stats()).encode()
            if op == OP_LOAD:
                return self._h_load(body)
            if op == OP_REPL:
                return self._h_repl(body)
            if op == OP_SYNC:
                return self._h_sync()
            if op == OP_WATERMARK:
                # the cheap invalidation probe: a caching reader pays
                # 9 bytes, not a row payload, to learn whether pushes
                # landed since it last filled
                self._stats["probes"] += 1
                return (bytes([ST_OK])
                        + struct.pack("<Q", self.state.version))
        return bytes([ST_ERR]) + f"unknown op {op}".encode()

    # locklint: holds-lock(every handler runs inside _dispatch's
    # `with self._lock:` block)
    def _h_register(self, body: bytes) -> bytes:
        trainer, ttl = struct.unpack_from("<qd", body)
        token = self._leases.grant(trainer,
                                   ttl if ttl > 0 else None).token
        # (re-)registering mid-pass does NOT resurrect a finished vote:
        # a fresh lease joins the CURRENT pass unfinished
        self._pass_finished.discard(trainer)
        # the reply carries this trainer's applied-epoch watermark so a
        # RESTARTED trainer (fresh client, epochs at 0) resumes its
        # epoch sequence past it — without this, its first N pushes
        # would be silently DUP-discarded against the old watermark
        return (bytes([ST_OK])
                + struct.pack("<QqQ", token, self._pass_num,
                              self.state.epochs.get(trainer, 0)))

    # locklint: holds-lock(every handler runs inside _dispatch's
    # `with self._lock:` block)
    def _h_heartbeat(self, body: bytes) -> bytes:
        trainer, token = struct.unpack_from("<qQ", body)
        if not self._leases.renew(trainer, token):
            return bytes([ST_LEASE_EXPIRED])
        return bytes([ST_OK])

    # locklint: holds-lock(every handler runs inside _dispatch's
    # `with self._lock:` block)
    def _h_get_rows(self, body: bytes) -> bytes:
        (n,) = struct.unpack_from("<I", body)
        ids = np.frombuffer(body, np.int64, n, offset=4)
        self._fault("get_recv")
        self._stats["gets"] += 1
        rows = self.state.take_rows(ids)
        # the reply carries the shard's applied-update watermark next to
        # the rows: both are read under the dispatch lock, so a caching
        # reader can stamp every filled row with the exact version it
        # reflects (the push-watermark invalidation protocol)
        return (bytes([ST_OK]) + struct.pack("<IQ", n, self.state.version)
                + np.ascontiguousarray(rows, np.float32).tobytes())

    # locklint: holds-lock(every handler runs inside _dispatch's
    # `with self._lock:` block)
    def _h_push(self, body: bytes) -> bytes:
        trainer, epoch, lr, n = struct.unpack_from("<qQdI", body)
        off = struct.calcsize("<qQdI")
        ids = np.frombuffer(body, np.int64, n, offset=off)
        grads = np.frombuffer(
            body, np.float32, n * self.state.dim,
            offset=off + n * 8).reshape(n, self.state.dim)
        self._fault("push_recv")
        # a push implicitly renews (any token incarnation: the push
        # epoch check is the dedup authority, not the lease token)
        if not self._leases.renew(trainer):
            return bytes([ST_LEASE_EXPIRED])
        applied = self.state.apply_push(trainer, epoch, ids, grads, lr)
        if applied:
            self._stats["pushes"] += 1
            self._replicate(
                bytes([_REPL_PUSH])
                + struct.pack("<qQdI", trainer, epoch, lr, n)
                + ids.tobytes() + np.ascontiguousarray(grads).tobytes())
        else:
            self._stats["duplicates"] += 1
        self._fault("push_pre_ack")
        # every push ACK rides the post-apply watermark, so the pushing
        # trainer (and anything sharing its client's on_watermark seam,
        # e.g. a co-resident read cache) learns the shard moved without
        # a second RPC
        return (bytes([ST_OK if applied else ST_DUP])
                + struct.pack("<Q", self.state.version))

    # locklint: holds-lock(every handler runs inside _dispatch's
    # `with self._lock:` block)
    def _h_finish_pass(self, body: bytes) -> bytes:
        trainer, token = struct.unpack_from("<qQ", body)
        if not self._lease_ok(trainer, token):
            return bytes([ST_LEASE_EXPIRED])
        self._pass_finished.add(trainer)
        self._check_pass_done()
        return (bytes([ST_OK]) + struct.pack("<q", self._pass_num)
                + struct.pack("<B", not self._pass_finished))

    # locklint: holds-lock(every handler runs inside _dispatch's
    # `with self._lock:` block)
    def _h_load(self, body: bytes) -> bytes:
        row_lo, n = struct.unpack_from("<qI", body)
        vals = np.frombuffer(
            body, np.float32, n * self.state.dim,
            offset=struct.calcsize("<qI")).reshape(n, self.state.dim)
        self.state.apply_load(row_lo, vals)
        self._replicate(bytes([_REPL_LOAD]) + struct.pack("<qI", row_lo, n)
                        + np.ascontiguousarray(vals).tobytes())
        return bytes([ST_OK])

    def _replicate(self, record: bytes) -> None:
        """Forward one applied update down the chain; runs under the
        state lock, so the backup applies in exactly the primary's
        order. The version stamp lets the backup ignore records it has
        already seen (a primary retry after a flaky link).

        A LOST link means the backup may have missed records — sending
        further increments would let it apply over a gap and silently
        diverge. Instead, the link stays quiet and is periodically
        (every `repl_retry_s`, NOT every push — a full-state encode +
        connect attempt per push would turn a dead backup into a
        latency tax on every trainer) offered the FULL current state;
        only a successful resync returns it to incremental records."""
        if self._repl is None:
            return
        if self._repl.lost:
            now = self.clock()
            if now - self._repl.last_resync_attempt < self.repl_retry_s:
                return      # degraded-but-available: don't pay per push
            self._repl.last_resync_attempt = now
            self._repl.send(
                bytes([OP_REPL]) + struct.pack("<Q", self.state.version)
                + bytes([_REPL_STATE]) + _encode_state(self.state))
            return
        self._repl.send(bytes([OP_REPL])
                        + struct.pack("<Q", self.state.version) + record)

    # locklint: holds-lock(every handler runs inside _dispatch's
    # `with self._lock:` block)
    def _h_repl(self, body: bytes) -> bytes:
        (version,) = struct.unpack_from("<Q", body)
        kind = body[8]
        rec = body[9:]
        self._fault("repl_apply")
        if version <= self.state.version:
            return bytes([ST_OK])     # already have it (link retry)
        if kind != _REPL_STATE and version != self.state.version + 1:
            # an incremental record from PAST a gap (we restarted, or
            # missed records while unreachable): applying it would
            # silently diverge from the primary — refuse, which marks
            # the primary's link lost and triggers a full-state resync
            log.warning("pserver %s: refusing replication record v%d "
                        "over a gap (at v%d) — requesting resync",
                        self.name, version, self.state.version)
            return bytes([ST_NEED_RESYNC])
        if kind == _REPL_PUSH:
            trainer, epoch, lr, n = struct.unpack_from("<qQdI", rec)
            off = struct.calcsize("<qQdI")
            ids = np.frombuffer(rec, np.int64, n, offset=off)
            grads = np.frombuffer(
                rec, np.float32, n * self.state.dim,
                offset=off + n * 8).reshape(n, self.state.dim)
            self.state.apply_push(trainer, epoch, ids, grads, lr)
        elif kind == _REPL_LOAD:
            row_lo, n = struct.unpack_from("<qI", rec)
            vals = np.frombuffer(
                rec, np.float32, n * self.state.dim,
                offset=struct.calcsize("<qI")).reshape(n, self.state.dim)
            self.state.apply_load(row_lo, vals)
        elif kind == _REPL_STATE:
            # full resync after the primary's link to us degraded:
            # adopt wholesale (covers whatever records we missed)
            self.state.adopt(_decode_state(rec, self.state.dim))
            self._stats["repl_resyncs"] += 1
            return bytes([ST_OK])
        else:
            return bytes([ST_ERR]) + f"bad repl kind {kind}".encode()
        self._stats["repl_records"] += 1
        return bytes([ST_OK])

    def _h_sync(self) -> bytes:
        return bytes([ST_OK]) + _encode_state(self.state)

    def stats(self) -> dict:
        return dict(self._stats,
                    version=self.state.version,
                    pass_num=self._pass_num,
                    live_trainers=len(self._leases),
                    replica_lost=bool(self._repl and self._repl.lost),
                    last_snapshot_error=self.last_snapshot_error)

    def bind_metrics(self, registry, *, prefix: str = "pserver",
                     labels: Optional[dict] = None) -> None:
        """Register `stats()` as a read-through source on an
        `obs.MetricsRegistry` — the registry's sanitizer maps
        replica_lost (bool) to 0/1 and drops last_snapshot_error (str);
        everything else exports as the very ledger OP_STATS serves."""
        registry.register_source(
            prefix, self.stats,
            labels={"shard": str(self.shard_id), **(labels or {})})


def _encode_state(st: ShardState) -> bytes:
    ek = np.asarray(sorted(st.epochs), np.int64)
    ev = np.asarray([st.epochs[k] for k in sorted(st.epochs)], np.int64)
    return (struct.pack("<QqqI", st.version, st.row_lo, st.row_hi,
                        len(ek))
            + ek.tobytes() + ev.tobytes()
            + np.ascontiguousarray(st.rows, np.float32).tobytes())


def _decode_state(blob: bytes, dim: int, offset: int = 0) -> ShardState:
    version, row_lo, row_hi, n_ep = struct.unpack_from("<QqqI", blob,
                                                       offset)
    off = offset + struct.calcsize("<QqqI")
    ek = np.frombuffer(blob, np.int64, n_ep, offset=off)
    ev = np.frombuffer(blob, np.int64, n_ep, offset=off + n_ep * 8)
    st = ShardState(row_lo, row_hi, dim)
    st.rows = np.frombuffer(
        blob, np.float32, (row_hi - row_lo) * dim,
        offset=off + 2 * n_ep * 8).reshape(row_hi - row_lo, dim).copy()
    st.version = version
    st.epochs = {int(k): int(v) for k, v in zip(ek, ev)}
    return st


def _decode_sync(resp: bytes, dim: int) -> ShardState:
    return _decode_state(resp, dim, offset=1)


# -- topology helpers ----------------------------------------------------


class ShardSpec:
    """Client-visible description of one shard: its row range and its
    endpoints in failover order (primary first)."""

    def __init__(self, shard_id: int, row_lo: int, row_hi: int,
                 endpoints: List[Tuple[str, int]]):
        self.shard_id = shard_id
        self.row_lo = row_lo
        self.row_hi = row_hi
        self.endpoints = list(endpoints)

    def __repr__(self):
        return (f"ShardSpec({self.shard_id}, [{self.row_lo}, "
                f"{self.row_hi}), {self.endpoints})")


def start_shard_pair(shard_id: int, row_lo: int, row_hi: int, dim: int,
                     **kw) -> Tuple[PServerShard, PServerShard, ShardSpec]:
    """Launch a primary + backup chain for one row range: the backup
    comes up first (it must be reachable for the primary's replication
    link), then the primary pointing at it. Extra kwargs go to BOTH
    shards (snapshot_dir gets per-role file names via `name`)."""
    name = kw.pop("name", f"shard-{shard_id}")
    backup = PServerShard(shard_id, row_lo, row_hi, dim,
                          name=f"{name}-backup", **kw)
    primary = PServerShard(shard_id, row_lo, row_hi, dim,
                           name=f"{name}-primary",
                           replica_addr=backup.addr, **kw)
    spec = ShardSpec(shard_id, row_lo, row_hi,
                     [primary.addr, backup.addr])
    return primary, backup, spec


class PServerGroup:
    """N replicated shards covering a [vocab, dim] table with the
    `shard_rows` layout (row r lives on shard r // rows_per_shard —
    vocab must divide, pad it up exactly like shard_rows demands)."""

    def __init__(self, vocab: int, dim: int, n_shards: int = 1, *,
                 replicated: bool = True, **kw):
        if vocab % n_shards != 0:
            raise ValueError(f"vocab {vocab} not divisible by "
                             f"{n_shards} shards; pad the table")
        self.vocab, self.dim = vocab, dim
        rows_per_shard = vocab // n_shards
        self.primaries: List[PServerShard] = []
        self.backups: List[PServerShard] = []
        self.specs: List[ShardSpec] = []
        for s in range(n_shards):
            lo, hi = s * rows_per_shard, (s + 1) * rows_per_shard
            if replicated:
                p, b, spec = start_shard_pair(s, lo, hi, dim, **kw)
                self.backups.append(b)
            else:
                p = PServerShard(s, lo, hi, dim, **kw)
                spec = ShardSpec(s, lo, hi, [p.addr])
            self.primaries.append(p)
            self.specs.append(spec)

    def stop(self) -> None:
        for sh in self.primaries + self.backups:
            sh.stop()

    def bind_metrics(self, registry, *, prefix: str = "pserver",
                     labels: Optional[dict] = None) -> None:
        """Register every shard (primaries AND backups) on the
        registry; the role label separates the replication tiers."""
        for sh in self.primaries:
            sh.bind_metrics(registry, prefix=prefix,
                            labels={"role": "primary", **(labels or {})})
        for sh in self.backups:
            sh.bind_metrics(registry, prefix=prefix,
                            labels={"role": "backup", **(labels or {})})

    def __enter__(self) -> "PServerGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
