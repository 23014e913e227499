"""Socket transport for cross-process serving replicas (port of
`paddle_tpu.serve.transport`: host-side delivery only, the JAX module
over the port's server and router; every payload that crosses a frame
is host data -- numpy arrays and Python values, never a tensor).

`ServingRouter` was written against in-process `ServingServer` objects:
one Python process, shared memory, a method call can't get lost. A
process fleet (serve.fleet) breaks every one of those assumptions — a
replica lives in its own OS process, reachable only over a socket that
can time out, deliver a request whose reply is lost, or die mid-frame
with the child. This module makes that boundary invisible to the
router by splitting the problem in three:

- **`ReplicaTransportServer`** (runs inside the replica process): a
  thread-per-connection RPC loop over one `ServingServer`, speaking
  the fleet wire idiom (`paddle_tpu_torch.wire` 4-byte-LE frames, pickled
  `(op, kwargs, acks)` -> `(status, payload, state)`). One lock
  serializes every op — the scheduler underneath is single-threaded
  by design and stays that way.

- **`ReplicaClient`** (router side): `ShardConn`-grade delivery — a
  fresh socket per attempt, bounded retries, exponential backoff with
  full jitter, and a hard distinction between CONNECT failures (the
  child isn't listening — maybe booting, maybe dead) and MID-FLIGHT
  failures (the frame went out and the reply never came — the op may
  or may not have executed). The client only retries because every op
  above it is idempotent by construction (below); it never decides
  semantics.

- **`ProcessReplica`** (router side): the duck-type adapter. It walks
  and quacks like a `ServingServer` for every surface the router
  touches (submit/step/results/pending_requests/counters/reconcile/
  ping/drain/queue/withdraw_queued + the disagg handoff surface), so
  `ServingRouter` code paths — redistribution, retirement, breaker
  probes, ledger harvest — run UNCHANGED against a process fleet.

Exactly-once across a lossy RPC link, without a distributed
transaction:

- **Tag-idempotent mutations.** `submit` and `import_request` carry a
  client-minted tag; the server caches the verdict (req_id OR the
  exception) per tag, so a retry of a lost reply returns the original
  verdict instead of double-admitting. `withdraw_queued`,
  `handoff_complete` and `cancel_handoff` cache by req_id the same
  way — an ACK replay releases nothing twice.
- **State rides every reply.** Each response carries the replica's
  ledger delta: counters, load, queue ids, retry budgets for pending
  work, and every terminal `RequestResult` the client has not yet
  ACKed. Results are redelivered until acked (acks piggyback on the
  next request), so a lost reply loses nothing, and a result + the
  counter increment that records it travel in ONE frame — the fleet
  counters the router aggregates can never be half-updated by a kill
  between two RPCs.
- **The mirror ledger.** `ProcessReplica` keeps a router-side copy of
  every request it routed here (`Request` objects on the ROUTER's
  clock). `pending_requests()` — the harvest surface the router reads
  after a replica death — answers from that mirror without touching
  the socket, because the whole point of the harvest is that the
  process on the other end is gone.

Death and fencing: when the RPC budget is exhausted on the data path,
the child is either dead or WEDGED (alive but not answering). Before
raising the replica-fatal error that triggers the router's
redistribution, `ProcessReplica` SIGKILLs the child — a wedged
process must not wake up and keep decoding requests the router just
handed to survivors (the classic split-brain double-serve). Probe
failures are gentler: while the process is visibly alive they are
transient (the breaker's job); only a dead process turns a probe into
a death verdict.

Two data-plane economies ride the same frames:

- **Out-of-band buffers.** The client speaks pickle protocol 5 over
  `wire.send_frames` multi-part frames: ndarray payloads (prompts,
  inline KV on the fallback path) travel as raw buffer parts instead
  of being copied into the pickle stream — one serialization, no
  sender-side concatenation. A new-protocol request is marked by a
  4-tuple `(op, kwargs, acks, proto)`; legacy 3-tuple single-frame
  clients get legacy single-frame replies, byte-compatible with the
  first protocol.
- **Batched sweeps.** `_op_sweep` dispatches a LIST of ops from one
  frame under one lock grab — `ProcessReplica` defers ACK-class ops
  (handoff_complete / cancel_handoff) and folds them into the next
  step/sync frame, and every reply's state block carries a `partials`
  map so streaming polls are answered router-side with ZERO RPCs.
  Control-plane syscall count stops scaling with request count; the
  `rpc_frames_coalesced` counter proves it.

The link is pickle over a loopback/private socket between same-uid
processes the supervisor itself spawned — a trusted link, same as the
pserver tier. Frames are bounded by `wire.MAX_FRAME` before
allocation either way (summed across parts for multi-part frames).
"""

from __future__ import annotations

import dataclasses
import pickle
import socket
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

# the router and server (and with them torch) load on first use: a
# replica process that serves no model (a lifecycle test's idle server)
# boots without them
from paddle_tpu_torch.wire import (MAX_FRAME, recv_frames, send_frame,
                             send_frames)

__all__ = [
    "ProcessReplica", "ReplicaClient", "ReplicaTransportServer",
    "TransportCallError", "TransportConnectError", "TransportError",
]


def _dumps(obj) -> List[bytes]:
    """Serialize with protocol-5 out-of-band buffers: part 0 is the
    pickle head, the rest are raw buffer views (ndarrays cross the
    socket without entering the pickle stream)."""
    bufs: List[pickle.PickleBuffer] = []
    head = pickle.dumps(obj, protocol=5,
                        buffer_callback=bufs.append)
    return [head] + [b.raw() for b in bufs]


def _loads(parts: List[bytes]):
    """Inverse of `_dumps`; a legacy single-frame pickle is just the
    zero-buffer case."""
    return pickle.loads(parts[0], buffers=[memoryview(p)
                                           for p in parts[1:]])


def _refuse_tensors(obj, where: str) -> None:
    """Raise TypeError if a torch tensor sits anywhere in `obj` (dicts,
    lists, tuples and dataclass fields are walked): frames carry host
    data only."""
    torch = sys.modules.get("torch")    # no torch loaded: no tensor
    if torch is not None and isinstance(obj, torch.Tensor):
        raise TypeError(
            f"{where} holds a torch tensor on {obj.device}: frames carry "
            f"host ndarrays only")
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    else:
        return
    for item in items:
        _refuse_tensors(item, where)


class TransportError(ConnectionError):
    """Retry budget exhausted against a replica transport. NOT
    replica-fatal by itself — `ProcessReplica` decides whether this
    means death (process gone / data path wedged) or a transient
    probe failure for the breaker."""


class TransportConnectError(TransportError):
    """Every attempt failed to CONNECT: nothing was delivered, the op
    certainly never executed."""


class TransportCallError(TransportError):
    """A connection was established and lost MID-FLIGHT (send or
    recv): the op may or may not have executed on the replica. Safe
    to surface only because every fleet op is idempotent (tags +
    ACKed result redelivery)."""


# ---------------------------------------------------------------------------
# replica side


class ReplicaTransportServer:
    """RPC loop exposing one `ServingServer` over the fleet wire
    protocol. Runs inside the replica process (`serve.fleet` boots it
    under a parent-death watchdog) or inside a thread for transport
    tests — it has no opinion about processes.

    Every op handler runs under one lock and returns `(status,
    payload, state)` where `state` is the ledger delta described in
    the module docstring. Unknown ops and undecodable frames answer
    with an error instead of killing the connection loop, except a
    frame-boundary failure — after that the stream is desynced and
    the connection dies (the client opens a fresh socket per attempt
    anyway)."""

    def __init__(self, server, *, host: str = "127.0.0.1",
                 port: int = 0, max_frame: int = MAX_FRAME):
        self.server = server
        self.max_frame = max_frame
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # idempotency ledgers (bounded by the request universe of one
        # replica lifetime — a replica process is disposable)
        self._acked: set = set()
        self._submit_tags: Dict[str, Tuple[str, Any]] = {}
        self._import_tags: Dict[str, Tuple[str, Any]] = {}
        self._withdrawn: set = set()
        self._handoff_released: set = set()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.addr: Tuple[str, int] = self._sock.getsockname()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def serve_forever(self, *, poll_s: float = 0.2,
                      tick: Optional[Callable[[], None]] = None) -> None:
        """Accept loop until `shutdown()`. `tick` runs between accept
        polls — the replica process hangs its parent-death watchdog
        check there."""
        self._sock.settimeout(poll_s)
        try:
            while not self._stop.is_set():
                if tick is not None:
                    tick()
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break               # listener closed under us
                t = threading.Thread(target=self._serve_conn,
                                     args=(conn,), daemon=True)
                t.start()
        finally:
            self._sock.close()

    def start(self) -> "ReplicaTransportServer":
        """Run the accept loop in a daemon thread (transport tests;
        the real replica process calls `serve_forever` directly)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._stop.set()

    # -- the connection loop -----------------------------------------------

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    parts = recv_frames(conn,
                                        max_frame=self.max_frame)
                except (ConnectionError, OSError):
                    return              # peer gone / desynced stream
                multi = False
                try:
                    req = _loads(parts)
                    if len(req) == 4:
                        # protocol-5 client: reply in kind (multi-
                        # part, buffers out-of-band)
                        op, kwargs, acks, _proto = req
                        multi = True
                    else:
                        op, kwargs, acks = req
                except Exception as e:
                    # garbage that FRAMED correctly: answer in-band
                    # (the client sees a protocol error, not a hang)
                    # and drop the connection — the stream's framing
                    # survived but its content is untrusted now
                    self._reply(conn, ("err", ConnectionError(
                        f"undecodable request frame: {e!r}"), None),
                        multi=False)
                    return
                self._reply(conn, self._dispatch(op, kwargs, acks),
                            multi=multi)
        finally:
            conn.close()

    def _reply(self, conn: socket.socket, reply: tuple, *,
               multi: bool) -> None:
        try:
            blobs = (_dumps(reply) if multi
                     else [pickle.dumps(reply)])
        except Exception as e:
            # an unpicklable exception payload must not silence the
            # reply — degrade to its repr
            status, payload, state = reply
            blobs = [pickle.dumps(
                (status, RuntimeError(repr(payload)), state))]
        try:
            if multi:
                send_frames(conn, blobs, max_frame=self.max_frame)
            else:
                send_frame(conn, blobs[0], max_frame=self.max_frame)
        except (ConnectionError, OSError):
            pass        # client gone; redelivery covers the loss

    def _dispatch(self, op: str, kwargs: dict, acks: list) -> tuple:
        handler = getattr(self, f"_op_{op}", None)
        with self._lock:
            self._acked.update(acks)
            if handler is None:
                return ("err", ConnectionError(f"unknown op {op!r}"),
                        self._state_block())
            try:
                ret = handler(**kwargs)
            except Exception as e:
                return ("err", e, self._state_block())
            return ("ok", ret, self._state_block())

    def _state_block(self) -> dict:
        """The ledger delta carried on EVERY reply (ok or err):
        snapshot counters/gauges plus unACKed terminal results and
        the live retry budgets the router-side mirror refreshes
        from. One frame = results + the counters that count them,
        atomically."""
        srv = self.server
        pending = srv.pending_requests()
        return {
            "counters": srv.counters(),
            "draining": bool(srv.draining),
            "queue_space": int(srv.queue_space),
            "load": int(srv.load()),
            "results": {rid: r for rid, r in srv.results.items()
                        if rid not in self._acked},
            "budgets": [(r.req_id, r.retries_left) for r in pending],
            "queued": [r.req_id for r in srv.queue],
            "handoffs": list(srv.ready_handoffs()),
            # one partials block per reply: the edge's per-stream
            # polling reads THIS off the router-side cache instead of
            # issuing one RPC per stream per poll
            "partials": {r.req_id: list(srv.partial_tokens(r.req_id))
                         for r in pending},
        }

    # -- ops ---------------------------------------------------------------

    def _op_info(self) -> dict:
        srv = self.server
        eng = srv.engine
        return {
            "role": getattr(srv, "role", "unified"),
            "paged": bool(getattr(eng, "paged", False)),
            "prefix_cache": bool(getattr(eng, "prefix_cache", False)),
            "page_size": int(getattr(eng, "page_size", 0) or 0),
            "max_retries": srv.max_retries,
            "default_deadline_ms": srv.default_deadline_ms,
        }

    def _op_ping(self) -> None:
        self.server.ping()

    def _op_sync(self) -> None:
        """No-op: exists so a caller can refresh the state block (and
        deliver ACKs) without side effects."""

    def _op_step(self) -> bool:
        return bool(self.server.step())

    def _op_sweep(self, ops: list) -> list:
        """Batched dispatch: a LIST of `(op, kwargs)` pairs executed
        in order under the one lock grab the frame already holds —
        the router folds its per-sweep ACKs (handoff releases) and
        the sweep's step into ONE frame per replica. Each sub-op
        answers `("ok", ret)` or `("err", e)` individually; the state
        block on the enclosing reply reflects the ledger AFTER the
        whole batch."""
        out = []
        for op, kwargs in ops:
            handler = (None if op == "sweep"
                       else getattr(self, f"_op_{op}", None))
            if handler is None:
                out.append(("err",
                            ConnectionError(f"unknown op {op!r}")))
                continue
            try:
                out.append(("ok", handler(**(kwargs or {}))))
            except Exception as e:
                out.append(("err", e))
        return out

    def _op_submit(self, tag: str, prompt, max_new: int,
                   deadline_ms, sampling, retries_left,
                   trace_id) -> int:
        cached = self._submit_tags.get(tag)
        if cached is not None:
            kind, value = cached
            if kind == "raise":
                raise value
            return value
        try:
            req_id = self.server.submit(
                prompt, max_new=max_new, deadline_ms=deadline_ms,
                sampling=sampling, retries_left=retries_left,
                trace_id=trace_id)
        except Exception as e:
            # cache the verdict — a replayed tag must get the SAME
            # rejection (it already has a terminal result child-side)
            self._submit_tags[tag] = ("raise", e)
            raise
        self._submit_tags[tag] = ("ok", req_id)
        return req_id

    def _op_withdraw_queued(self, req_id: int) -> bool:
        if req_id in self._withdrawn:
            return True         # ACK replay: already withdrawn once
        req = self.server.withdraw_queued(req_id)
        if req is None:
            return False
        self._withdrawn.add(req_id)
        return True

    def _op_cancel(self, req_id: int, reason: str) -> bool:
        # naturally idempotent (a terminal request answers False), so
        # no tag ledger: a replayed cancel re-expires nothing
        return bool(self.server.cancel(req_id, reason=reason))

    def _op_partial(self, req_id: int) -> list:
        # read-only streaming poll — the HTTP edge's chunk source
        return list(self.server.partial_tokens(req_id))

    def _op_drain(self, grace_s, reason: str) -> None:
        self.server.drain(grace_s=grace_s, reason=reason)

    def _op_reconcile(self) -> None:
        self.server.reconcile()

    def _op_export_request(self, req_id: int) -> dict:
        payload = dict(self.server.export_request(req_id))
        # the engine exports host ndarrays (and a DecodeSeed of host
        # values): a tensor here -- above all a CUDA one, which would
        # unpickle onto the router's device -- is refused, never sent
        _refuse_tensors(payload, "export_request payload")
        payload["prompt"] = np.asarray(payload["prompt"])
        if payload.get("kv") is not None:
            payload["kv"] = [
                tuple(np.asarray(p) if not isinstance(p, tuple)
                      else tuple(np.asarray(q) for q in p)
                      for p in layer)
                for layer in payload["kv"]]
        # else: the KV bytes live in the shared-memory arena and the
        # frame carries only the ticket (payload["kv_ref"])
        return payload

    def _op_handoff_complete(self, req_id: int) -> None:
        if req_id in self._handoff_released:
            return              # idempotent ACK: never release twice
        self.server.handoff_complete(req_id)
        self._handoff_released.add(req_id)

    def _op_cancel_handoff(self, req_id: int) -> None:
        if req_id in self._handoff_released:
            return
        self.server.cancel_handoff(req_id)
        self._handoff_released.add(req_id)

    def _op_import_request(self, tag: str, payload: dict) -> int:
        cached = self._import_tags.get(tag)
        if cached is not None:
            kind, value = cached
            if kind == "raise":
                raise value
            return value
        try:
            req_id = self.server.import_request(payload)
        except Exception as e:
            self._import_tags[tag] = ("raise", e)
            raise
        self._import_tags[tag] = ("ok", req_id)
        return req_id

    def _op_shutdown(self) -> None:
        self._stop.set()


# ---------------------------------------------------------------------------
# router side


class ReplicaClient:
    """Bounded-retry RPC client for one replica transport endpoint.

    The `ShardConn` delivery idiom (parallel.pserver_client): a FRESH
    socket per attempt, exponential backoff capped at `backoff_max`
    with full jitter (`rng.uniform(0, ceiling) or ceiling / 2` — the
    `or` guards the measure-zero 0.0 draw so a retry never busy-spins),
    and distinct terminal errors for connect-exhaustion vs mid-flight
    loss. `sleep` and `seed` are injectable so transport tests run in
    virtual time with deterministic jitter.

    `call` returns the raw `(status, payload, state)` triple; SEMANTIC
    interpretation (re-raising replica exceptions, absorbing state)
    belongs to `ProcessReplica` — keeping this class pure delivery."""

    def __init__(self, addr: Tuple[str, int], *,
                 connect_timeout: float = 1.0,
                 io_timeout: float = 10.0,
                 retries: int = 8,
                 backoff_base: float = 0.02,
                 backoff_max: float = 1.0,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 max_frame: int = MAX_FRAME):
        self.addr = tuple(addr)
        self.connect_timeout = connect_timeout
        self.io_timeout = io_timeout
        self.retries = retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.max_frame = max_frame
        self._sleep = sleep
        import random
        self._rng = random.Random(seed)
        # io accounting for the data-plane A/B bench: frames that
        # completed, and payload bytes either way (headers excluded)
        self.frames = 0
        self.bytes_sent = 0
        self.bytes_recv = 0

    def _backoff(self, attempt: int) -> None:
        ceiling = min(self.backoff_max,
                      self.backoff_base * (2 ** attempt))
        self._sleep(self._rng.uniform(0, ceiling) or ceiling / 2)

    def call(self, op: str, kwargs: Optional[dict] = None, *,
             acks: tuple = (), retries: Optional[int] = None) -> tuple:
        """One RPC with delivery retries. Raises
        `TransportConnectError` when no attempt ever connected,
        `TransportCallError` when the last failure was mid-flight.
        Retrying a mid-flight loss is safe ONLY because the ops are
        idempotent — tags replay verdicts, results redeliver until
        ACKed."""
        budget = self.retries if retries is None else retries
        # protocol-5 multi-part: the 4th tuple element marks a new-
        # protocol client, buffers (ndarrays) ride out-of-band parts
        parts = _dumps((op, dict(kwargs or {}), list(acks), 5))
        sent = sum(len(p) for p in parts)
        last: Optional[Exception] = None
        connected_once = False
        for attempt in range(budget):
            if attempt:
                self._backoff(attempt - 1)
            try:
                sock = socket.create_connection(
                    self.addr, timeout=self.connect_timeout)
            except OSError as e:
                last = e
                continue
            connected_once = True
            try:
                sock.settimeout(self.io_timeout)
                send_frames(sock, parts, max_frame=self.max_frame)
                reply = recv_frames(sock, max_frame=self.max_frame)
            except (ConnectionError, OSError) as e:
                last = e
                continue
            finally:
                sock.close()
            try:
                obj = _loads(reply)
            except Exception as e:
                last = ConnectionError(f"undecodable reply: {e!r}")
                continue
            self.frames += 1
            self.bytes_sent += sent
            self.bytes_recv += sum(len(p) for p in reply)
            return obj
        cls = (TransportCallError if connected_once
               else TransportConnectError)
        raise cls(f"rpc {op!r} to {self.addr} failed after "
                  f"{budget} attempts: {last!r}") from last


class _EngineInfo:
    """The three engine attributes the router reads off
    `servers[0].engine` to derive its affinity-key geometry —
    mirrored from the replica process at connect time."""

    def __init__(self, paged: bool, prefix_cache: bool,
                 page_size: int):
        self.paged = paged
        self.prefix_cache = prefix_cache
        self.page_size = page_size


class ProcessReplica:
    """A `ServingServer` duck type backed by a replica process over
    `ReplicaClient`. `ServingRouter` drives it exactly like an
    in-process server; the differences live entirely in here:

    - `results`/`counters()`/`load`/`queue_space`/`draining` answer
      from the state block absorbed off the LAST reply — never an
      extra RPC, always coherent with the results delivered in that
      same frame.
    - `pending_requests()` and `queue` answer from the router-side
      MIRROR ledger (`Request` objects whose deadlines live on the
      router's clock), because the harvest/retire paths that read
      them must keep working when the process is a corpse.
    - transport exhaustion on the data path FENCES the child
      (SIGKILL via the process handle) before raising the
      replica-fatal error, so a wedged-but-alive replica cannot keep
      serving requests the router just redistributed.
    """

    #: probes fail fast — the breaker wants a verdict, not a stall
    PROBE_RETRIES = 2

    def __init__(self, client: ReplicaClient, *, proc=None,
                 clock: Callable[[], float] = time.monotonic):
        self._client = client
        self._proc = proc
        self.clock = clock
        self.results: Dict[int, Any] = {}
        self._mirror: Dict[int, Request] = {}
        self._next_tag = 0
        self._counters: Dict[str, int] = {}
        self._draining = False
        self._queue_space = 0
        self._load = 0
        self._queued_ids: List[int] = []
        self._handoff_ids: List[int] = []
        # batched control plane: partials cache off the last
        # state block (streaming polls answered with ZERO RPCs),
        # deferred ACK-class ops folded into the next sweep frame
        self._partials: Dict[int, List[int]] = {}
        self._deferred: List[Tuple[str, dict]] = []
        self._deferred_released: set = set()
        self.rpc_frames_coalesced = 0
        self.rpc_deferred_errors = 0
        info = self._rpc("info")
        self.role = info["role"]
        self.engine = _EngineInfo(info["paged"], info["prefix_cache"],
                                  info["page_size"])
        self.max_retries = info["max_retries"]
        self.default_deadline_ms = info["default_deadline_ms"]

    # -- plumbing ----------------------------------------------------------

    def _tag(self) -> str:
        self._next_tag += 1
        return f"t{self._next_tag}"

    def _absorb(self, state: dict) -> None:
        self._counters = state["counters"]
        self._draining = state["draining"]
        self._queue_space = state["queue_space"]
        self._load = state["load"]
        self._queued_ids = state["queued"]
        self._handoff_ids = state["handoffs"]
        self._partials = state.get("partials", {})
        for rid, res in state["results"].items():
            if rid not in self.results:
                self.results[rid] = res
            self._mirror.pop(rid, None)
        for rid, budget in state["budgets"]:
            req = self._mirror.get(rid)
            if req is not None:
                req.retries_left = budget

    def _rpc(self, op: str, kwargs: Optional[dict] = None, *,
             probing: bool = False):
        try:
            status, payload, state = self._client.call(
                op, kwargs, acks=tuple(self.results),
                retries=self.PROBE_RETRIES if probing else None)
        except TransportError as e:
            self._transport_failure(e, probing=probing)
            raise AssertionError("unreachable")  # pragma: no cover
        if state is not None:
            self._absorb(state)
        if status == "err":
            if getattr(payload, "replica_fatal", False):
                # the replica's OWN engine died: fence the process
                # too — a half-dead child must not linger
                self._fence()
            raise payload
        return payload

    def _transport_failure(self, e: Exception, *,
                           probing: bool) -> None:
        if self._proc is not None and not self._proc.alive():
            self._fatal(e)      # the process is a corpse: death
        if probing:
            raise e             # alive but slow: the breaker's call
        # data-path budget exhausted with the process still alive:
        # WEDGED. Fence it before failing over, or it may wake up and
        # double-serve what the router is about to redistribute.
        self._fatal(e)

    def _flush(self, final_op: str,
               final_kwargs: Optional[dict] = None):
        """Fold every deferred ACK-class op plus `final_op` into ONE
        sweep frame. Deferred-op errors can't reach their original
        callers (those calls already returned) — a replica-fatal one
        still fences + raises; the rest are counted and dropped,
        which is safe because every deferred op is an idempotent
        release (the request's outcome was already recorded before
        the op was enqueued). The final op's verdict is returned or
        re-raised exactly like a direct RPC."""
        ops = self._deferred + [(final_op, dict(final_kwargs or {}))]
        self._deferred = []
        results = self._rpc("sweep", dict(ops=ops))
        # N ops, 1 frame: N-1 frames that never hit the wire
        self.rpc_frames_coalesced += len(ops) - 1
        for kind, value in results[:-1]:
            if kind == "err":
                if getattr(value, "replica_fatal", False):
                    self._fence()
                    raise value
                self.rpc_deferred_errors += 1
        kind, value = results[-1]
        if kind == "err":
            if getattr(value, "replica_fatal", False):
                self._fence()
            raise value
        return value

    def _fence(self) -> None:
        if self._proc is not None:
            self._proc.kill()

    def _fatal(self, cause: Exception) -> None:
        self._fence()
        from paddle_tpu_torch.serve.router import ReplicaDeadError

        err = ReplicaDeadError(
            f"replica transport to {self._client.addr} lost: {cause}")
        raise err from cause

    # -- the ServingServer duck type ---------------------------------------

    def submit(self, prompt, *, max_new: int,
               deadline_ms=-1, sampling: Optional[dict] = None,
               retries_left: Optional[int] = None,
               trace_id: Optional[str] = None) -> int:
        from paddle_tpu_torch.serve.server import Request

        arr = np.asarray(prompt)
        now = self.clock()
        req_id = self._rpc("submit", dict(
            tag=self._tag(), prompt=arr, max_new=max_new,
            deadline_ms=deadline_ms, sampling=sampling,
            retries_left=retries_left, trace_id=trace_id))
        # mirror the admitted request with its deadline re-expressed
        # on the ROUTER's clock — the harvest path recomputes
        # remaining time from this after the child is gone
        eff = (self.default_deadline_ms if deadline_ms == -1
               else deadline_ms)
        deadline = None if eff is None else now + float(eff) / 1000.0
        true_len = int(arr.size) if arr.ndim == 1 else 0
        self._mirror[req_id] = Request(
            req_id=req_id, prompt=arr, true_len=true_len,
            max_new=max_new, sampling=sampling, deadline=deadline,
            submitted_at=now,
            retries_left=(self.max_retries if retries_left is None
                          else retries_left))
        return req_id

    def step(self) -> bool:
        if self._deferred:
            return bool(self._flush("step"))
        return bool(self._rpc("step"))

    def ping(self) -> None:
        if self._proc is not None and not self._proc.alive():
            self._fatal(ConnectionError(
                f"replica process exited "
                f"(exitcode={self._proc.exitcode()})"))
        self._rpc("ping", probing=True)

    def load(self) -> int:
        return self._load

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def queue_space(self) -> int:
        return self._queue_space

    @property
    def queue(self) -> List[Request]:
        return [self._mirror[rid] for rid in self._queued_ids
                if rid in self._mirror]

    def pending_requests(self) -> List[Request]:
        return [req for rid, req in sorted(self._mirror.items())
                if rid not in self.results]

    def counters(self) -> Dict[str, int]:
        c = dict(self._counters)
        # merge the router-side control-plane economics so the fleet
        # aggregation (and banked-at-death sums) pick them up
        c["rpc_frames_coalesced"] = self.rpc_frames_coalesced
        c["rpc_deferred_errors"] = self.rpc_deferred_errors
        c["rpc_client_frames"] = self._client.frames
        c["rpc_client_bytes_sent"] = self._client.bytes_sent
        c["rpc_client_bytes_recv"] = self._client.bytes_recv
        return c

    def reconcile(self) -> None:
        if self._deferred:
            self._flush("reconcile")
        else:
            self._rpc("reconcile")

    def drain(self, *, grace_s: Optional[float] = None,
              reason: str = "drain requested") -> None:
        self._rpc("drain", dict(grace_s=grace_s, reason=reason))

    def withdraw_queued(self, req_id: int) -> Optional[Request]:
        if self._rpc("withdraw_queued", dict(req_id=req_id)):
            return self._mirror.pop(req_id, None)
        return None

    def cancel(self, req_id: int, *,
               reason: str = "client cancelled") -> bool:
        return bool(self._rpc("cancel",
                              dict(req_id=req_id, reason=reason)))

    def partial_tokens(self, req_id: int) -> List[int]:
        res = self.results.get(req_id)
        if res is not None:
            return list(res.tokens)
        if req_id in self._partials:
            # push-style delivery: the last reply's partials block
            # already carries this stream's tokens — no RPC. Fresh by
            # construction: tokens only advance via step RPCs, and
            # every step refreshes the block.
            self.rpc_frames_coalesced += 1
            return list(self._partials[req_id])
        return list(self._rpc("partial", dict(req_id=req_id)))

    def sync(self) -> None:
        """Refresh the cached state block (and deliver ACKs) with no
        side effects — the supervisor's idle-watch uses this."""
        if self._deferred:
            self._flush("sync")
        else:
            self._rpc("sync")

    # -- disaggregated handoff surface -------------------------------------

    def ready_handoffs(self) -> List[int]:
        # a handoff whose release is deferred (queued for the next
        # sweep frame) must not be harvested again in between
        return [rid for rid in self._handoff_ids
                if rid not in self._deferred_released]

    def export_request(self, req_id: int) -> dict:
        return self._rpc("export_request", dict(req_id=req_id))

    def handoff_complete(self, req_id: int) -> None:
        # deferred ACK: the destination already owns the request (its
        # import committed), so the source's pin release is pure
        # bookkeeping — it folds into the next sweep frame instead of
        # costing one RPC per migration. A crash before the flush is
        # covered by the same machinery as a crash before this call:
        # the pin is abandoned and dropped/reclaimed.
        self._deferred.append(("handoff_complete",
                               dict(req_id=req_id)))
        self._deferred_released.add(req_id)
        self._mirror.pop(req_id, None)      # the destination owns it

    def cancel_handoff(self, req_id: int) -> None:
        # cancel resumes the request SOURCE-side: flush immediately
        # (deferring would leave the request frozen for a sweep)
        if req_id in self._deferred_released:
            return
        self._flush("cancel_handoff", dict(req_id=req_id))
        self._deferred_released.add(req_id)

    def import_request(self, payload: dict) -> int:
        from paddle_tpu_torch.serve.server import Request

        now = self.clock()
        req_id = self._rpc("import_request",
                           dict(tag=self._tag(), payload=payload))
        rem = payload.get("remaining_ms")
        arr = np.asarray(payload["prompt"])
        self._mirror[req_id] = Request(
            req_id=req_id, prompt=arr,
            true_len=int(payload["true_len"]),
            max_new=int(payload["max_new"]),
            sampling=payload.get("sampling"),
            deadline=(None if rem is None
                      else now + float(rem) / 1000.0),
            submitted_at=now,
            retries_left=int(payload.get("retries_left",
                                         self.max_retries)))
        return req_id

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self) -> None:
        """Best-effort remote stop (drained replicas exit their serve
        loop on this); transport loss here is fine — the supervisor
        escalates to terminate/kill on its own timetable."""
        try:
            self._client.call("shutdown", retries=1)
        except TransportError:
            pass
