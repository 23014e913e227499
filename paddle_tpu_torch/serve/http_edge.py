"""HTTP front door: the streaming network edge over the serving fleet
(port of `paddle_tpu.serve.http_edge`: stdlib sockets and JSON over the
port's router, and `POST /v1/ctr/score` over the port's
`serve.ctr.CtrServer`; no device value is touched here).

`HttpEdge` is a stdlib-only streaming HTTP/1.1 server — the same raw-
socket discipline `wire.py`/`transport.py` prove (accept loop with a
poll timeout, daemon thread per connection, caps validated BEFORE
allocation) — fronting a `ServingRouter`. One POST = one generation
request; tokens stream back via chunked transfer encoding as the
decode loop emits them.

The edge's defensive contract (docs/RELIABILITY.md "Network-edge
fault model"): a slow, malicious, or vanished client must never wedge
a decode slot, pin KV pages, or skew a co-tenant's p99.

- **Backpressure, not buffering.** Admission is gated on the fleet's
  own queue: `queue_space() <= 0` answers 429 + Retry-After at the
  edge, `draining` answers 503 — overload never accumulates
  unbounded per-connection state.
- **Disconnect = cancel.** Client departure is detected at every
  chunk write (and by an EOF probe between chunks); the cancel path
  reuses the deadline/retire machinery (`ServingServer.cancel` pulls
  the request's deadline to now, so the proven `_expire_*` →
  `_retire_slot` path frees the slot, its pages, and any parked
  handoff pins mid-generation) and `reconcile()` stays clean.
- **Hardened parsing.** Header/body caps are enforced before the
  bytes are accumulated; malformed requests answer 400 in-band;
  slow-loris header/body reads time out and close the connection
  WITHOUT touching the router.
- **Graceful drain.** SIGTERM (or `drain()`) stops admitting: new
  requests answer 503 + Retry-After, in-flight streams run to their
  natural end, and the drain report is emitted once idle.

Threading: the router is single-threaded by design, so ALL router
interaction — the drive thread's `sweep()`, every handler's
submit/cancel/partial-poll — runs under one lock. Handlers block on
the lock for at most one decode step; the streams themselves (socket
writes) happen outside it.

Protocol (tokenizer-agnostic, like the CLI: token ids in, token ids
out):

    POST /v1/generate
    X-Deadline-Ms: 2000                  (optional, relative ms)
    {"prompt": [1,2,3], "max_new": 16,
     "sampling": {...}?, "stream": true?}

    => 200, Transfer-Encoding: chunked — one JSON line per chunk:
       {"tokens": [..new..]} ... {"done": true, "outcome": "...",
       "n_tokens": N, "error": null}
    => 429 + Retry-After (queue full), 503 + Retry-After (draining),
       400 (malformed), 404/405/411/413/431 as usual.

    GET /healthz  => {"draining": ..., "queue_space": ...}
    GET /metrics  => Prometheus text exposition (registry-bound edges)
"""

from __future__ import annotations

import json
import os
import select
import signal
import socket
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from paddle_tpu_torch.serve.server import QueueFullError

#: HTTP status reasons for the subset the edge speaks
_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    411: "Length Required", 413: "Payload Too Large",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    503: "Service Unavailable",
}

#: TTFT / inter-token-gap histogram buckets (seconds) — sub-ms to
#: tens of seconds, the envelope CPU-backed tiny models and real
#: fleets both land in
_LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class _HttpReject(Exception):
    """A request answered IN-BAND with an error status (the client
    framed something we refuse) — the connection stays orderly."""

    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


class _SlowLoris(Exception):
    """Header/body read timed out: the client is feeding us bytes
    slower than the timeout allows. Close WITHOUT replying (a reply
    would be one more buffer the attacker made us hold) and without
    touching the router."""


class _ClientGone(Exception):
    """The peer closed (EOF / reset) — nothing to answer."""


class HttpEdge:
    """The streaming HTTP front door over one `ServingRouter`.

    `router` supplies admission (`submit`/`queue_space`/`draining`),
    streaming reads (`partial_tokens`), cancellation (`cancel`) and
    the ledger (`results`); `sweep_fn` is the drive tick (default
    `router.sweep` — a fleet supervisor passes its own `sweep` so
    autoscale/reap ticks ride the same loop) and `submit_fn`
    overrides admission the same way. `clock` is the injectable
    timebase for every TTFT/ITG measurement (GL007: metrics and
    spans share one timeline)."""

    def __init__(self, router, *, host: str = "127.0.0.1",
                 port: int = 0,
                 sweep_fn: Optional[Callable[[], bool]] = None,
                 submit_fn: Optional[Callable] = None,
                 drain_fn: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None, tracer=None,
                 max_header_bytes: int = 8192,
                 max_body_bytes: int = 1 << 20,
                 header_timeout_s: float = 5.0,
                 body_timeout_s: float = 5.0,
                 poll_s: float = 0.05,
                 stream_poll_s: float = 0.002,
                 retry_after_s: float = 1.0,
                 drain_report_path: Optional[str] = None,
                 ctr=None):
        self.router = router
        # optional CTR scoring backend (serve.ctr.CtrServer): mounts
        # POST /v1/ctr/score so recommender traffic enters the same
        # front door as generation traffic
        self.ctr = ctr
        self._sweep_fn = sweep_fn if sweep_fn is not None else router.sweep
        self._submit_fn = (submit_fn if submit_fn is not None
                           else router.submit)
        self._drain_fn = drain_fn
        self.clock = clock
        self.tracer = tracer
        self.max_header_bytes = int(max_header_bytes)
        self.max_body_bytes = int(max_body_bytes)
        self.header_timeout_s = float(header_timeout_s)
        self.body_timeout_s = float(body_timeout_s)
        self.poll_s = float(poll_s)
        self.stream_poll_s = float(stream_poll_s)
        self.retry_after_s = float(retry_after_s)
        self.drain_report_path = drain_report_path
        # ONE lock for every router interaction (module docstring)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._draining = False
        self._drain_reason: Optional[str] = None
        # set by the signal handler, applied by the drive loop: the
        # handler itself must never take self._lock (locklint LK005)
        self._pending_drain: Optional[str] = None
        self._drain_report: Optional[dict] = None
        self._next_cid = 0
        self._active_streams = 0
        # the edge ledger — exported via register_source("edge", ...)
        # so the edge's metric names (edge_connections, ...) come out
        # of the standard exporter with zero bespoke plumbing
        self._stats: Dict[str, int] = {
            "connections": 0, "requests": 0, "completed": 0,
            "disconnect_cancels": 0, "shed_429": 0, "shed_503": 0,
            "malformed_400": 0, "hangups": 0, "active_streams": 0,
            "ctr_requests": 0,
        }
        self._ttft_hist = None
        self._itg_hist = None
        if registry is not None:
            registry.register_source("edge", self.counters)
            self._ttft_hist = registry.histogram(
                "edge_ttft_seconds",
                "time-to-first-token per streamed HTTP request",
                buckets=_LATENCY_BUCKETS)
            self._itg_hist = registry.histogram(
                "edge_itg_seconds",
                "inter-token gap within streamed HTTP responses",
                buckets=_LATENCY_BUCKETS)
        self._registry = registry
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.addr: Tuple[str, int] = self._sock.getsockname()
        self._accept_thread: Optional[threading.Thread] = None
        self._drive_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "HttpEdge":
        """Run the accept loop and the drive loop, each in a daemon
        thread; `addr` is already bound (port 0 = ephemeral)."""
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="edge-accept")
        self._drive_thread = threading.Thread(
            target=self._drive_loop, daemon=True, name="edge-drive")
        self._accept_thread.start()
        self._drive_thread.start()
        return self

    def close(self) -> None:
        """Stop both loops and release the listener. Idempotent; does
        NOT drain — call `drain()` + `wait_drained()` first for the
        graceful path."""
        self._stop.set()
        self._wake.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for t in (self._accept_thread, self._drive_thread):
            if t is not None and t.is_alive():
                t.join(timeout=2.0)

    def install_signals(self) -> None:
        """SIGTERM/SIGINT → graceful drain (edge first, then the
        fleet via `drain_fn`). Survives non-main-thread callers the
        same way ServingServer does: signal handlers are a process-
        level convenience, not a correctness dependency.

        The handler only SETS A FLAG (locklint LK005): it runs
        between bytecodes of whatever the main thread was doing —
        possibly inside `self._lock` — so taking the lock (or
        logging) from it can deadlock the process. The drive loop
        applies the pending drain within one `poll_s` park."""
        def handler(signum, frame):
            self._pending_drain = f"signal {signum}"

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass                    # not the main thread

    # -- drain -------------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, *, reason: str = "drain requested") -> None:
        """Stop admitting: newcomers answer 503 + Retry-After while
        in-flight streams run to their natural end. Chains into
        `drain_fn` (the fleet's own drain) when provided, so the
        SIGTERM sequence is edge drain → fleet drain → report."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._drain_reason = reason
        if self._drain_fn is not None:
            self._drain_fn(reason)
        else:
            self.router.drain(reason=reason)
        self._wake.set()

    def wait_drained(self, *, timeout_s: float = 30.0,
                     poll_s: float = 0.01) -> bool:
        """Block until every in-flight stream has finished AND the
        fleet is idle (or `timeout_s` of wall time passes — flow
        control, deliberately NOT the injectable clock). Emits the
        drain report on success when `drain_report_path` is set."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                busy = self._sweep_fn()
                idle = self._active_streams == 0 and not busy
            if idle and self._draining:
                self._write_drain_report()
                return True
            if idle:
                return True
            time.sleep(poll_s)
        return False

    def _write_drain_report(self) -> dict:
        with self._lock:
            report = {
                "kind": "edge_drain_report",
                "reason": self._drain_reason,
                "edge": dict(self._stats),
                "fleet": dict(self.router.counters()),
            }
            self._drain_report = report
        if self.drain_report_path:
            tmp = f"{self.drain_report_path}.tmp"
            with open(tmp, "w") as f:
                json.dump(report, f, indent=1)
            os.replace(tmp, self.drain_report_path)
        return report

    # -- observability -----------------------------------------------------

    def counters(self) -> Dict[str, int]:
        """The edge ledger (register this as the `edge` source):
        connections accepted, requests admitted, disconnect cancels,
        edge sheds by status, in-band parse rejections, hangups that
        never touched the router, and the live stream gauge."""
        with self._lock:
            out = dict(self._stats)
        out["active_streams"] = self._active_streams
        return out

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] = self._stats.get(key, 0) + n

    # -- the drive loop ----------------------------------------------------

    def _drive_loop(self) -> None:
        """The fleet's single drive loop: `sweep_fn` under the shared
        lock, parked briefly when idle (handlers `_wake` it on every
        submit/cancel so admission latency is bounded by one park).
        Between two busy sweeps it yields the interpreter once: the
        lock is not fair, and a loop that re-takes it at once starves
        the handlers waiting on it (their submits and snapshots then
        land only when the fleet idles), which breaks the one-step
        bound the module docstring promises."""
        while not self._stop.is_set():
            pending = self._pending_drain
            if pending is not None:
                self._pending_drain = None
                self.drain(reason=pending)
            with self._lock:
                busy = self._sweep_fn()
            if not busy:
                self._wake.wait(self.poll_s)
                self._wake.clear()
            else:
                time.sleep(0)

    # -- the accept loop ---------------------------------------------------

    def _accept_loop(self) -> None:
        self._sock.settimeout(self.poll_s)
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break               # listener closed under us
            with self._lock:
                self._stats["connections"] += 1
                cid = self._next_cid
                self._next_cid += 1
            t = threading.Thread(target=self._serve_conn,
                                 args=(conn, cid), daemon=True,
                                 name=f"edge-conn-{cid}")
            t.start()

    # -- request parsing (hardened: caps before allocation) ----------------

    def _read_request(self, conn: socket.socket):
        conn.settimeout(self.header_timeout_s)
        buf = b""
        while b"\r\n\r\n" not in buf:
            # cap checked BEFORE the next recv extends the buffer: an
            # attacker cannot make us hold more than one recv past it
            if len(buf) > self.max_header_bytes:
                raise _HttpReject(
                    431, f"header block exceeds "
                         f"{self.max_header_bytes} bytes")
            try:
                chunk = conn.recv(4096)
            except socket.timeout:
                raise _SlowLoris("header read timed out")
            except (ConnectionError, OSError):
                raise _ClientGone()
            if not chunk:
                raise _ClientGone()
            buf += chunk
        head, rest = buf.split(b"\r\n\r\n", 1)
        if len(head) > self.max_header_bytes:
            raise _HttpReject(
                431,
                f"header block exceeds {self.max_header_bytes} bytes")
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise _HttpReject(
                400, f"malformed request line {lines[0]!r}")
        method, target, _version = parts
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" not in line:
                raise _HttpReject(400, f"malformed header {line!r}")
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
        body = b""
        if method == "POST":
            raw = headers.get("content-length")
            if raw is None:
                raise _HttpReject(
                    411, "POST without Content-Length")
            try:
                n = int(raw)
            except ValueError:
                raise _HttpReject(
                    400, f"malformed Content-Length {raw!r}")
            if n < 0:
                raise _HttpReject(
                    400, f"negative Content-Length {n}")
            # the cap is enforced on the DECLARED length, before one
            # body byte is read or buffered
            if n > self.max_body_bytes:
                raise _HttpReject(
                    413, f"body of {n} bytes exceeds "
                         f"{self.max_body_bytes}")
            conn.settimeout(self.body_timeout_s)
            body = rest
            while len(body) < n:
                try:
                    chunk = conn.recv(min(65536, n - len(body)))
                except socket.timeout:
                    raise _SlowLoris("body read timed out")
                except (ConnectionError, OSError):
                    raise _ClientGone()
                if not chunk:
                    raise _ClientGone()
                body += chunk
            body = body[:n]
        return method, target, headers, body

    # -- responses ---------------------------------------------------------

    @staticmethod
    def _head(status: int, extra: Dict[str, str],
              *, chunked: bool, length: int = 0) -> bytes:
        lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}",
                 "Content-Type: application/json",
                 "Connection: close"]
        if chunked:
            lines.append("Transfer-Encoding: chunked")
        else:
            lines.append(f"Content-Length: {length}")
        lines.extend(f"{k}: {v}" for k, v in extra.items())
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    def _respond(self, conn: socket.socket, status: int, body: dict,
                 *, extra: Optional[Dict[str, str]] = None) -> None:
        blob = (json.dumps(body) + "\n").encode()
        try:
            conn.sendall(self._head(status, extra or {},
                                    chunked=False, length=len(blob))
                         + blob)
        except (ConnectionError, OSError):
            pass                    # client gone: nothing owed

    @staticmethod
    def _send_chunk(conn: socket.socket, text: str) -> None:
        data = text.encode()
        conn.sendall(f"{len(data):x}\r\n".encode("latin-1")
                     + data + b"\r\n")

    @staticmethod
    def _settle(conn: socket.socket) -> None:
        """Graceful close for a REJECTED request: the client may
        still have bytes in flight we never read (an over-cap header
        block, a 413'd body we refused to touch), and close() with
        unread receive data RSTs the connection — which can destroy
        the error reply before the client reads it. Send FIN, then
        drain a BOUNDED amount so the reply survives; the bound keeps
        a hostile sender from turning the courtesy into a hold."""
        try:
            conn.settimeout(0.2)
            conn.shutdown(socket.SHUT_WR)
            for _ in range(8):
                if not conn.recv(4096):
                    break
        except (socket.timeout, OSError):
            pass

    @staticmethod
    def _client_gone(conn: socket.socket) -> bool:
        """EOF probe between chunks: a half-closed client shows up as
        a readable socket answering b'' — caught here even when no
        token is due, so an idle stream cancels promptly too."""
        try:
            r, _, _ = select.select([conn], [], [], 0)
            if not r:
                return False
            return conn.recv(1) == b""
        except (ConnectionError, OSError, ValueError):
            return True

    # -- the connection handler --------------------------------------------

    def _serve_conn(self, conn: socket.socket, cid: int) -> None:
        try:
            try:
                method, target, headers, body = self._read_request(conn)
            except _HttpReject as e:
                self._count("malformed_400")
                self._respond(conn, e.status, {"error": e.detail})
                self._settle(conn)
                return
            except _SlowLoris:
                # close WITHOUT a reply and without touching the
                # router: the read deadline is the whole defense
                self._count("hangups")
                return
            except _ClientGone:
                self._count("hangups")
                return
            try:
                self._route(conn, cid, method, target, headers, body)
            except _HttpReject as e:
                if e.status == 400:
                    self._count("malformed_400")
                self._respond(conn, e.status, {"error": e.detail})
                self._settle(conn)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _route(self, conn, cid, method, target, headers, body):
        if target == "/healthz" and method == "GET":
            with self._lock:
                payload = {
                    "draining": (self._draining
                                 or bool(self.router.draining)),
                    "queue_space": int(self.router.queue_space()),
                    "active_streams": self._active_streams,
                }
            self._respond(conn, 200, payload)
            return
        if target == "/metrics" and method == "GET":
            if self._registry is None:
                raise _HttpReject(404, "no metrics registry bound")
            text = self._registry.to_prometheus().encode()
            try:
                conn.sendall(
                    b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: text/plain; version=0.0.4\r\n"
                    + f"Content-Length: {len(text)}\r\n".encode()
                    + b"Connection: close\r\n\r\n" + text)
            except (ConnectionError, OSError):
                pass
            return
        if target == "/v1/ctr/score":
            if method != "POST":
                raise _HttpReject(405, f"{method} on /v1/ctr/score")
            if self.ctr is None:
                raise _HttpReject(404, "no CTR backend bound")
            try:
                payload = json.loads(body.decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                raise _HttpReject(400, f"body is not JSON: {e}")
            try:
                result = self.ctr.score_request(payload)
            except ValueError as e:
                raise _HttpReject(400, str(e))
            self._count("ctr_requests")
            self._respond(conn, 200, result)
            return
        if target != "/v1/generate":
            raise _HttpReject(404, f"unknown target {target!r}")
        if method != "POST":
            raise _HttpReject(405, f"{method} on /v1/generate")
        self._generate(conn, cid, headers, body)

    def _parse_generate(self, headers, body):
        try:
            payload = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise _HttpReject(400, f"body is not JSON: {e}")
        if not isinstance(payload, dict):
            raise _HttpReject(400, "body must be a JSON object")
        try:
            prompt = np.asarray(payload["prompt"], dtype=np.int32)
            max_new = int(payload["max_new"])
        except (KeyError, TypeError, ValueError, OverflowError) as e:
            raise _HttpReject(
                400, f"prompt/max_new malformed: {e}")
        sampling = payload.get("sampling")
        if sampling is not None and not isinstance(sampling, dict):
            raise _HttpReject(400, "sampling must be an object")
        stream = bool(payload.get("stream", True))
        deadline_ms = -1
        raw = headers.get("x-deadline-ms")
        if raw is not None:
            try:
                deadline_ms = float(raw)
            except ValueError:
                raise _HttpReject(
                    400, f"malformed X-Deadline-Ms {raw!r}")
        return prompt, max_new, sampling, stream, deadline_ms

    def _generate(self, conn, cid, headers, body):
        prompt, max_new, sampling, stream, deadline_ms = \
            self._parse_generate(headers, body)
        retry = {"Retry-After": f"{self.retry_after_s:g}"}
        tid = f"http{cid}"
        if self.tracer is not None:
            # the edge's OWN span (Tracer.start dedupes live ids, so
            # it cannot share rr<N>); it joins the fleet span via the
            # rr_id tag below + the http_attached event on rr<N>
            self.tracer.start(tid, "edge.request",
                              target="/v1/generate")
        outcome = "error"
        try:
            # admission VERDICT under the lock, rejection WRITE
            # outside it (locklint LK003): _respond's sendall is
            # peer-paced — a client that stops reading must stall
            # only its own connection thread, never the router lock
            # every stream's poll loop shares
            reject = None
            rr_id = None
            t0 = 0.0
            with self._lock:
                if self._draining or self.router.draining:
                    self._stats["shed_503"] += 1
                    outcome = "shed_503"
                    reject = (503, {"error": "draining",
                                    "reason": self._drain_reason},
                              retry)
                # backpressure mapped onto the ADMISSION QUEUE: the
                # edge never buffers what the fleet has no room for
                elif self.router.queue_space() <= 0:
                    self._stats["shed_429"] += 1
                    outcome = "shed_429"
                    reject = (429, {"error": "queue full"}, retry)
                else:
                    t0 = self.clock()
                    try:
                        rr_id = self._submit_fn(
                            prompt, max_new=max_new,
                            deadline_ms=deadline_ms,
                            sampling=sampling)
                    except ValueError as e:
                        outcome = "rejected"
                        reject = (400, {"error": str(e)}, None)
                    except QueueFullError as e:
                        # raced the gate (or a router-level shed):
                        # same 429 the gate would have given
                        self._stats["shed_429"] += 1
                        outcome = "shed_429"
                        reject = (429, {"error": str(e)}, retry)
                    else:
                        self._stats["requests"] += 1
                        self._active_streams += 1
            if reject is not None:
                status, payload, extra = reject
                self._respond(conn, status, payload, extra=extra)
                return
            self._wake.set()
            if self.tracer is not None:
                self.tracer.event(tid, "submitted", rr_id=rr_id)
                self.tracer.event(self.router.trace_id(rr_id),
                                  "http_attached", http=cid)
            try:
                outcome = self._stream_tokens(conn, cid, rr_id, t0,
                                              stream=stream)
                if outcome == "completed":
                    self._count("completed")
            finally:
                with self._lock:
                    self._active_streams -= 1
        finally:
            if self.tracer is not None:
                self.tracer.end(tid, outcome)

    def _snapshot(self, rr_id):
        """(terminal result or None, tokens so far) in ONE lock
        hold — a result landing between two reads would let the
        stream miss its tail."""
        with self._lock:
            res = self.router.results.get(rr_id)
            toks = (list(res.tokens) if res is not None
                    else self.router.partial_tokens(rr_id))
        # plain ints: the engine emits numpy scalars, json refuses them
        return res, [int(t) for t in toks]

    def _cancel(self, rr_id, why: str) -> None:
        with self._lock:
            cancelled = self.router.cancel(rr_id, reason=why)
            if cancelled:
                self._stats["disconnect_cancels"] += 1
        self._wake.set()

    def _stream_tokens(self, conn, cid, rr_id, t0, *,
                       stream: bool) -> str:
        """Pump tokens to the client until the request is terminal.
        `sent` is this stream's high-water mark: after a replica loss
        the fleet's partial count steps backward while a survivor
        regenerates the identical greedy prefix, so we only ever
        write tokens BEYOND what this client already has — a
        redistribution is invisible on the wire."""
        sent = 0
        last_emit = None
        headers_sent = False
        while True:
            res, toks = self._snapshot(rr_id)
            fresh = toks[sent:] if len(toks) > sent else []
            try:
                if fresh and stream:
                    if not headers_sent:
                        conn.sendall(self._head(200, {}, chunked=True))
                        headers_sent = True
                    now = self.clock()
                    if last_emit is None:
                        if self._ttft_hist is not None:
                            self._ttft_hist.observe(now - t0)
                    elif self._itg_hist is not None:
                        gap = (now - last_emit) / len(fresh)
                        for _ in fresh:
                            self._itg_hist.observe(gap)
                    last_emit = now
                    self._send_chunk(
                        conn, json.dumps({"tokens": fresh}) + "\n")
                    sent = len(toks)
                if res is not None:
                    tail = {"done": True, "outcome": res.outcome,
                            "n_tokens": len(toks), "error": res.error}
                    if stream:
                        if not headers_sent:
                            conn.sendall(
                                self._head(200, {}, chunked=True))
                        self._send_chunk(
                            conn, json.dumps(tail) + "\r\n")
                        conn.sendall(b"0\r\n\r\n")
                    else:
                        tail["tokens"] = toks
                        self._respond(conn, 200, tail)
                    return res.outcome
                # DISCONNECT DETECTION between chunks: EOF probe (an
                # orderly close arrives long before a write fails)
                if self._client_gone(conn):
                    raise _ClientGone()
            except (_ClientGone, ConnectionError, OSError):
                # the chunk write (or probe) saw the client leave:
                # free the slot/pages mid-generation via the deadline
                # machinery and stop paying for this stream
                if self.tracer is not None:
                    self.tracer.event(f"http{cid}", "disconnect",
                                      sent=sent)
                self._cancel(rr_id, f"client disconnect (http{cid})")
                return "disconnected"
            if not fresh:
                # nothing flowed this turn: yield to the drive thread
                time.sleep(self.stream_poll_s)
