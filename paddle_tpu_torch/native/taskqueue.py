"""Task-queue master bindings: in-process (ctypes) + TCP client.

Mirrors the reference Go master's API surface (reference:
go/master/service.go GetTask/TaskFinished/TaskFailed, snapshot/recover,
RequestSaveModel; go/master/client.go NextRecord streaming).
"""

from __future__ import annotations

import ctypes
import enum
import json
import os
import random as _random
import re
import socket
import struct
import threading
from typing import Optional, Tuple

from paddle_tpu_torch.native.build import ensure_built
from paddle_tpu_torch.wire import recv_frame, send_frame


class TaskStatus(enum.IntEnum):
    OK = 0
    NOT_STARTED = 1    # ErrPassBefore equivalent
    PENDING_WAIT = 2   # todo drained, leases outstanding
    PASS_END = 3       # ErrPassAfter equivalent


def _lib():
    lib = ctypes.CDLL(ensure_built())
    c = ctypes
    lib.tq_create.restype = c.c_void_p
    lib.tq_create.argtypes = [c.c_int64, c.c_int]
    lib.tq_destroy.argtypes = [c.c_void_p]
    lib.tq_add_task.restype = c.c_uint64
    lib.tq_add_task.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.tq_start.argtypes = [c.c_void_p]
    lib.tq_get_task.restype = c.c_uint8
    lib.tq_get_task.argtypes = [c.c_void_p, c.POINTER(c.c_uint64),
                                c.c_char_p, c.c_uint64,
                                c.POINTER(c.c_uint64)]
    lib.tq_finish_task.restype = c.c_int
    lib.tq_finish_task.argtypes = [c.c_void_p, c.c_uint64]
    lib.tq_fail_task.restype = c.c_int
    lib.tq_fail_task.argtypes = [c.c_void_p, c.c_uint64]
    lib.tq_next_pass.restype = c.c_int64
    lib.tq_next_pass.argtypes = [c.c_void_p]
    lib.tq_pass.restype = c.c_int64
    lib.tq_pass.argtypes = [c.c_void_p]
    lib.tq_counts.argtypes = [c.c_void_p] + [c.POINTER(c.c_uint64)] * 4
    lib.tq_request_save_model.restype = c.c_int
    lib.tq_request_save_model.argtypes = [c.c_void_p, c.c_int64, c.c_int64]
    lib.tq_snapshot.restype = c.c_int
    lib.tq_snapshot.argtypes = [c.c_void_p, c.c_char_p]
    lib.tq_restore.restype = c.c_int
    lib.tq_restore.argtypes = [c.c_void_p, c.c_char_p]
    lib.tq_serve_start.restype = c.c_void_p
    lib.tq_serve_start.argtypes = [c.c_void_p, c.c_int]
    lib.tq_serve_port.restype = c.c_int
    lib.tq_serve_port.argtypes = [c.c_void_p]
    lib.tq_serve_stop.argtypes = [c.c_void_p]
    return lib


_cached = None


def get_lib():
    global _cached
    if _cached is None:
        _cached = _lib()
    return _cached


_MAX_PAYLOAD = 1 << 20


class TaskQueue:
    """In-process master core (the unit the TCP service wraps)."""

    def __init__(self, timeout_ms: int = 60000, max_retries: int = 3):
        self._lib = get_lib()
        self._h = self._lib.tq_create(timeout_ms, max_retries)

    def add_task(self, payload: bytes) -> int:
        tid = self._lib.tq_add_task(self._h, payload, len(payload))
        if tid == 0:
            raise ValueError(
                f"task payload of {len(payload)} bytes exceeds the "
                f"{_MAX_PAYLOAD}-byte cap (payloads are task specs, not data)")
        return tid

    def add_file_chunks(self, path: str, chunks_per_task: int = 1) -> int:
        """Partition a recordio file into chunk-range tasks (reference:
        go/master/service.go:106 partition). Payload is JSON
        {path, chunk_begin, chunk_end}."""
        from paddle_tpu_torch.native.recordio import count_chunks

        n = count_chunks(path)
        added = 0
        for begin in range(0, n, chunks_per_task):
            payload = json.dumps({
                "path": path, "chunk_begin": begin,
                "chunk_end": min(begin + chunks_per_task, n),
            }).encode()
            self.add_task(payload)
            added += 1
        return added

    def start(self):
        self._lib.tq_start(self._h)

    def get_task(self) -> Tuple[TaskStatus, int, bytes]:
        tid = ctypes.c_uint64()
        plen = ctypes.c_uint64()
        buf = ctypes.create_string_buffer(_MAX_PAYLOAD)
        st = self._lib.tq_get_task(self._h, ctypes.byref(tid), buf,
                                   _MAX_PAYLOAD, ctypes.byref(plen))
        status = TaskStatus(st)
        if status != TaskStatus.OK:
            return status, 0, b""
        return status, tid.value, buf.raw[: plen.value]

    def finish_task(self, task_id: int):
        """No-op (like the Go master) if the lease already timed out and
        the task was re-queued or completed elsewhere; raises only for an
        id the master never issued."""
        if self._lib.tq_finish_task(self._h, task_id) < 0:
            raise KeyError(f"unknown task id {task_id}")

    def fail_task(self, task_id: int):
        if self._lib.tq_fail_task(self._h, task_id) < 0:
            raise KeyError(f"unknown task id {task_id}")

    def next_pass(self) -> int:
        p = self._lib.tq_next_pass(self._h)
        if p < 0:
            raise RuntimeError("pass not drained: tasks still outstanding")
        return p

    @property
    def pass_num(self) -> int:
        return self._lib.tq_pass(self._h)

    def counts(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.tq_counts(self._h, *[ctypes.byref(v) for v in vals])
        return dict(zip(("todo", "pending", "done", "discarded"),
                        (v.value for v in vals)))

    def request_save_model(self, trainer_id: int, ttl_ms: int = 60000) -> bool:
        return bool(self._lib.tq_request_save_model(self._h, trainer_id,
                                                    ttl_ms))

    def snapshot(self, path: str):
        if self._lib.tq_snapshot(self._h, path.encode()) != 0:
            raise OSError(f"snapshot to {path} failed")

    def restore(self, path: str):
        rc = self._lib.tq_restore(self._h, path.encode())
        if rc != 0:
            raise OSError(f"restore from {path} failed (rc={rc})")

    def close(self):
        if self._h:
            self._lib.tq_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class MasterServer:
    """TCP service over a TaskQueue (loopback), replacing the Go RPC."""

    def __init__(self, queue: TaskQueue, port: int = 0):
        self.queue = queue
        self._lib = get_lib()
        self._srv = self._lib.tq_serve_start(queue._h, port)
        if not self._srv:
            raise OSError(f"cannot bind master service on port {port}")
        self.port = self._lib.tq_serve_port(self._srv)

    def stop(self):
        if self._srv:
            self._lib.tq_serve_stop(self._srv)
            self._srv = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


_OP_GET, _OP_FINISH, _OP_FAIL, _OP_NEXT_PASS, _OP_COUNTS = 1, 2, 3, 4, 5
_OP_SAVE_ELECT, _OP_ADD, _OP_START, _OP_PASS = 6, 7, 8, 9


class MasterClient:
    """Socket client for MasterServer (reference: go/master/client.go).

    Hardened against master death (the reference survives it via etcd
    re-discovery + gRPC retry; here the restarted master — HAMaster —
    comes back on the same address): every socket op carries a DEFAULT
    TIMEOUT (no call can block in recv forever on a dead peer), and
    `_call` retries with exponential backoff + jitter, reconnecting a
    fresh socket each attempt (a timeout mid-frame desyncs the framing,
    so the old socket is never reused). Idempotent ops retry freely:
    get_task re-issues a lease (a lost one expires), finish/fail on an
    already-resolved lease are tolerated no-ops server-side, and the
    rest of the retried set are reads. add_task and next_pass are NOT
    idempotent (a lost response + re-send would register a duplicate
    task / trip the next pass's drain check), so they get connection
    setup with retry but a SINGLE send attempt — a lost response
    surfaces as ConnectionError for the caller to resolve.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 timeout: float = 30.0, retries: int = 5,
                 backoff_base: float = 0.05, backoff_max: float = 2.0,
                 seed: Optional[int] = None):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.retries = retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self._rng = _random.Random(seed)
        self._sock: Optional[socket.socket] = None
        self._closed = False
        # eager connect, but through the same bounded backoff schedule
        # as every RPC: a master mid-restart is a normal condition
        self._with_retry(lambda: None)

    def _connect(self) -> None:
        # build fully configured before publishing to self._sock: a
        # failure between create and configure must release the fd
        # here, not leak it behind a half-initialized attribute
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout)
        try:
            sock.settimeout(self.timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except BaseException:
            sock.close()
            raise
        self._sock = sock

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _backoff(self, attempt: int) -> float:
        # full jitter: uniform in (0, base * 2^attempt], capped
        ceiling = min(self.backoff_base * (2 ** attempt),
                      self.backoff_max)
        return self._rng.uniform(0, ceiling) or ceiling / 2

    def _with_retry(self, fn):
        import time as _time

        if self._closed:
            raise RuntimeError(
                "MasterClient is closed — create a new client to "
                "reconnect")
        last: Optional[BaseException] = None
        ok = False
        try:
            for attempt in range(self.retries + 1):
                if attempt:
                    _time.sleep(self._backoff(attempt - 1))
                try:
                    if self._sock is None:
                        self._connect()
                    result = fn()
                    ok = True
                    return result
                except (ConnectionError, socket.timeout, OSError) as e:
                    last = e
                    self._drop_sock()
        finally:
            # ANY exit other than success — retries exhausted, or a
            # non-retried exception (KeyboardInterrupt, a bug in fn)
            # mid-attempt — must not strand an open socket on a
            # possibly-desynced frame boundary
            if not ok:
                self._drop_sock()
        raise ConnectionError(
            f"master at {self.host}:{self.port} unreachable after "
            f"{self.retries + 1} attempts: {last}") from last

    def _call(self, payload: bytes, idempotent: bool = True) -> bytes:
        def send_recv():
            send_frame(self._sock, payload)
            return recv_frame(self._sock)

        if idempotent:
            return self._with_retry(send_recv)
        # non-idempotent: RECONNECTING is safe, RE-SENDING is not (the
        # server may have processed the op and only the response was
        # lost) — retry connection setup, then one send attempt
        if self._sock is None:
            self._with_retry(lambda: None)
        try:
            return send_recv()
        except (ConnectionError, socket.timeout, OSError) as e:
            self._drop_sock()
            raise ConnectionError(
                f"non-idempotent op to {self.host}:{self.port} failed "
                f"mid-flight ({e}); NOT retried — the master may or "
                f"may not have applied it") from e

    def add_task(self, payload: bytes) -> int:
        resp = self._call(bytes([_OP_ADD]) + payload, idempotent=False)
        if resp[0] != 0:
            raise ValueError("task payload rejected (exceeds size cap)")
        return struct.unpack_from("<Q", resp, 1)[0]

    def start(self):
        self._call(bytes([_OP_START]))

    def get_task(self) -> Tuple[TaskStatus, int, bytes]:
        resp = self._call(bytes([_OP_GET]))
        status = TaskStatus(resp[0])
        if status != TaskStatus.OK:
            return status, 0, b""
        (tid,) = struct.unpack_from("<Q", resp, 1)
        return status, tid, resp[9:]

    def finish_task(self, task_id: int):
        resp = self._call(bytes([_OP_FINISH]) + struct.pack("<Q", task_id))
        if resp[0] == 255:
            raise KeyError(f"unknown task id {task_id}")

    def fail_task(self, task_id: int):
        resp = self._call(bytes([_OP_FAIL]) + struct.pack("<Q", task_id))
        if resp[0] == 255:
            raise KeyError(f"unknown task id {task_id}")

    def next_pass(self) -> int:
        resp = self._call(bytes([_OP_NEXT_PASS]), idempotent=False)
        (p,) = struct.unpack_from("<q", resp, 1)
        if p < 0:
            raise RuntimeError("pass not drained: tasks still outstanding")
        return p

    def counts(self) -> dict:
        resp = self._call(bytes([_OP_COUNTS]))
        vals = struct.unpack_from("<QQQQ", resp, 1)
        return dict(zip(("todo", "pending", "done", "discarded"), vals))

    def request_save_model(self, trainer_id: int, ttl_ms: int = 60000) -> bool:
        resp = self._call(bytes([_OP_SAVE_ELECT]) +
                          struct.pack("<qq", trainer_id, ttl_ms))
        return bool(resp[1])

    @property
    def pass_num(self) -> int:
        resp = self._call(bytes([_OP_PASS]))
        return struct.unpack_from("<q", resp, 1)[0]

    def close(self):
        """Release the socket and retire the client. Idempotent — safe
        to call any number of times, from __del__, or after a failed
        connect (the half-built client holds no socket then). A closed
        client refuses further RPCs with RuntimeError instead of
        silently reconnecting: reconnect-after-close was how leaked
        sockets escaped the drop path."""
        self._closed = True
        self._drop_sock()

    def __enter__(self) -> "MasterClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- record streaming (go/master/client.go NextRecord equivalent) --

    def record_reader(self, *, max_task_failures: int = 3,
                      poll_s: float = 0.05, exactly_once: bool = True):
        """Reader over the master's recordio-chunk tasks: pulls a task,
        reads ALL its records, then yields them; repeats until
        PASS_END. A read error fails the lease and moves on instead of
        killing the pass (reference: go/master/client.go taskFailed),
        up to `max_task_failures` consecutive failures; master death
        mid-pass is carried by `_call`'s reconnect. Tasks are chunk
        ranges, so the buffer is bounded.

        `exactly_once` picks the delivery tradeoff — buffering means a
        failure DURING the read never yields a partial task either way,
        the choice is when the lease is finished:

        - True (default): finish-then-yield. This consumer sees each
          record at most once (re-pulls after a failed read re-serve a
          task that yielded nothing) — but if the worker dies between
          finish and the consumer draining the buffer, those records
          are lost to the pass (the master counts the task done).
          Right for single-worker streams and restarts driven by
          `data.reader.retrying`, where re-yield would double-train.
        - False: yield-then-finish, the reference Go client's
          at-least-once. A worker death mid-yield lets the lease
          expire and ANOTHER worker re-serves the full task — no loss,
          but records yielded before the death are seen twice by the
          pass. Right for multi-worker pools that tolerate duplicates.
        """
        def reader():
            import time as _time

            failures = 0
            while True:
                status, tid, payload = self.get_task()
                if status == TaskStatus.PASS_END:
                    return
                if status in (TaskStatus.PENDING_WAIT,
                              TaskStatus.NOT_STARTED):
                    _time.sleep(poll_s)
                    continue
                try:
                    spec = json.loads(payload.decode())
                    from paddle_tpu_torch.native.recordio import RecordReader

                    with RecordReader(spec["path"], spec["chunk_begin"],
                                      spec["chunk_end"]) as rr:
                        recs = list(rr)
                except Exception:
                    failures += 1
                    try:
                        self.fail_task(tid)
                    except (KeyError, ConnectionError):
                        pass    # stale lease / dead master: requeues
                                # via lease timeout anyway
                    if failures > max_task_failures:
                        raise
                    continue
                failures = 0
                # a stale finish is a tolerated no-op server-side (the
                # task was re-served elsewhere after a lease timeout)
                if exactly_once:
                    self.finish_task(tid)
                    for rec in recs:
                        yield rec
                else:
                    for rec in recs:
                        yield rec
                    self.finish_task(tid)

        return reader


class HAMaster:
    """Restartable master: periodic snapshots to an external directory +
    recover-on-start.

    The reference survives master death via etcd: leader election lock
    (reference: go/master/etcd_client.go) and state snapshots stored IN
    etcd (reference: go/master/service.go:166 recover, :207 snapshot) so
    a new master process elected anywhere resumes the queue. In
    gang-scheduled TPU training the coordinator is restarted in place by
    the scheduler (k8s Job / JobSet restartPolicy), so this rebuild
    replaces multi-candidate election with restart-and-recover: point
    snapshot_dir at a shared filesystem (NFS / GCS-FUSE) and a master
    restarted ON ANY HOST recovers the queue — same durability contract,
    no consensus service to operate. Snapshots are atomic
    (tmp + os.replace) and pruned to the newest `keep`; lease epochs make
    pre-crash task handles stale after recovery (taskqueue.cc:125).
    """

    SNAP_RE = re.compile(r"^snap-(\d{8})\.tq$")

    def __init__(self, snapshot_dir: str, *, port: int = 0,
                 interval_s: float = 30.0, keep: int = 3,
                 timeout_ms: int = 60000, max_retries: int = 3):
        os.makedirs(snapshot_dir, exist_ok=True)
        self.dir = snapshot_dir
        self.keep = keep
        self.queue = TaskQueue(timeout_ms=timeout_ms,
                               max_retries=max_retries)
        newest = self.newest_snapshot(snapshot_dir)
        self.recovered_from = None
        if newest is not None:
            self.queue.restore(newest)
            self.recovered_from = newest
        self._seq = self._next_seq()
        self.server = MasterServer(self.queue, port=port)
        self.port = self.server.port
        self._stop = threading.Event()
        self._snap_lock = threading.Lock()
        self.last_snapshot_error: Optional[str] = None
        self.last_snapshot_time: Optional[float] = None
        self._thread = None
        if interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, args=(interval_s,), daemon=True)
            self._thread.start()

    @classmethod
    def newest_snapshot(cls, snapshot_dir: str) -> Optional[str]:
        try:
            names = sorted(n for n in os.listdir(snapshot_dir)
                           if cls.SNAP_RE.match(n))
        except FileNotFoundError:
            return None
        return os.path.join(snapshot_dir, names[-1]) if names else None

    def _next_seq(self) -> int:
        newest = self.newest_snapshot(self.dir)
        if newest is None:
            return 0
        return int(self.SNAP_RE.match(os.path.basename(newest)).group(1)) + 1

    def checkpoint(self) -> str:
        """Write one snapshot now; returns its published path.

        Serialized by a lock (the cadence thread and manual callers may
        race). The queue serializes to a LOCAL temp file first — the C
        snapshot holds the queue mutex while writing (taskqueue.cc
        tq_snapshot), and a multi-second NFS/GCS-FUSE write there would
        stall every worker RPC — then the bytes move to the shared dir
        outside the queue lock, with an atomic final rename."""
        import shutil
        import tempfile
        import time as _time

        with self._snap_lock:
            name = f"snap-{self._seq:08d}.tq"
            fd, local_tmp = tempfile.mkstemp(prefix="ptq-snap-")
            os.close(fd)
            shared_tmp = os.path.join(self.dir, f".{name}.tmp.{os.getpid()}")
            try:
                self.queue.snapshot(local_tmp)  # fast: local disk
                shutil.copyfile(local_tmp, shared_tmp)  # slow: off-lock
                final = os.path.join(self.dir, name)
                os.replace(shared_tmp, final)
            except BaseException as e:
                # don't leak a partial in the shared dir (a quota-full
                # dir of dead .tmp files would keep snapshots failing)
                try:
                    os.unlink(shared_tmp)
                except OSError:
                    pass
                # record the durability gap HERE, under the snapshot
                # lock — previously the cadence thread wrote
                # last_snapshot_error unlocked (a stale failure could
                # overwrite a newer success), and a failed MANUAL
                # checkpoint() never recorded it at all
                if isinstance(e, OSError):
                    self.last_snapshot_error = str(e)
                raise
            finally:
                try:
                    os.unlink(local_tmp)
                except OSError:
                    pass
            self._seq += 1
            self.last_snapshot_error = None
            self.last_snapshot_time = _time.time()
            for n in os.listdir(self.dir):
                full = os.path.join(self.dir, n)
                is_stale_tmp = n.startswith(".snap-") and ".tmp." in n
                try:
                    if is_stale_tmp:  # crashed writer's leftovers
                        os.unlink(full)
                except OSError:
                    pass
            names = sorted(n for n in os.listdir(self.dir)
                           if self.SNAP_RE.match(n))
            for stale in names[:-self.keep]:
                try:
                    os.unlink(os.path.join(self.dir, stale))
                except OSError:
                    pass
            return final

    def _loop(self, interval_s: float):
        import logging

        while not self._stop.wait(interval_s):
            try:
                self.checkpoint()
            except OSError as e:
                # keep retrying; checkpoint() already recorded the
                # durability gap (last_snapshot_error, under its
                # lock) — persistent failure means recovery would
                # restore stale state
                logging.getLogger(__name__).warning(
                    "HAMaster snapshot to %s failed: %s", self.dir, e)

    def stop(self, *, final_snapshot: bool = True):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if final_snapshot:
            try:
                self.checkpoint()
            except OSError:
                pass
        self.server.stop()
        self.queue.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
