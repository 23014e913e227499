"""Traffic harness for the HTTP front door: realistic load shapes,
a raw-socket streaming client, closed- and open-loop generators, and
the SLO report `bench.py --edge-only` gates on.

The shapes replay what production LLM traffic actually looks like
(ROADMAP item 1 — "heavy traffic from millions of users" as a
measured claim, not a metaphor):

- **Zipf prompt popularity** — a few prompt families dominate, so
  the paged pool's prefix cache gets realistic hit/miss mixture
  instead of all-hit or all-miss.
- **Heavy-tail output lengths** — most completions are short, a few
  run long (lognormal), the mixture that makes p99 inter-token gap
  an interesting number.
- **Ramp phases** (open loop) — arrival rate steps up over the run,
  exercising admission backpressure and fleet autoscaling.

Two drive disciplines, because they fail differently:

- `closed_loop`: N users, each waiting for its stream to finish
  before sending the next request — throughput self-limits, the
  latency numbers are honest.
- `open_loop`: requests fire on an arrival SCHEDULE regardless of
  completions — the generator that actually exposes overload
  (closed-loop clients politely slow down; real users do not).

Everything here is stdlib + numpy: the client speaks HTTP/1.1 with
chunked transfer decoding over a plain socket, so the harness tests
the edge's real wire behavior, not a requests-library abstraction.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# traffic shapes


@dataclasses.dataclass
class TrafficShape:
    """Sampler for realistic request shapes. `sample(rng)` returns
    `(prompt, max_new)`: the prompt is a Zipf-popular family prefix
    (shared across requests — the prefix-cache exerciser) plus a
    unique tail; `max_new` is heavy-tailed (lognormal over a base),
    capped so a tiny test engine can always fit it."""

    vocab: int = 61
    n_families: int = 8
    zipf_alpha: float = 1.2
    family_len: int = 8
    tail_len: int = 3
    out_base: int = 3
    out_sigma: float = 1.0
    out_cap: int = 20
    seed: int = 0

    def _zipf_p(self) -> np.ndarray:
        ranks = np.arange(1, self.n_families + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_alpha)
        return p / p.sum()

    def family_prefix(self, k: int) -> np.ndarray:
        """Family k's shared prefix — DETERMINISTIC in (seed, k), so
        every request in a family re-presents the identical prefix
        and the pool's chained block keys actually collide."""
        r = np.random.RandomState(self.seed * 7919 + k)
        return r.randint(1, self.vocab, size=self.family_len
                         ).astype(np.int32)

    def sample(self, rng: np.random.RandomState
               ) -> Tuple[np.ndarray, int]:
        k = int(rng.choice(self.n_families, p=self._zipf_p()))
        tail = rng.randint(1, self.vocab, size=self.tail_len
                           ).astype(np.int32)
        prompt = np.concatenate([self.family_prefix(k), tail])
        max_new = min(self.out_cap,
                      self.out_base
                      + int(rng.lognormal(0.0, self.out_sigma)))
        return prompt, max(1, max_new)


# ---------------------------------------------------------------------------
# the streaming client


@dataclasses.dataclass
class StreamResult:
    """One request's client-side record: HTTP status, terminal
    outcome (from the final chunk; `None` when the edge refused it
    before submission), the streamed tokens, time-to-first-token,
    and the per-token inter-token gaps."""

    status: int
    outcome: Optional[str] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    gaps_s: List[float] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    retry_after: Optional[str] = None
    aborted: bool = False


class _Reader:
    """Buffered socket reader (recv_full discipline: short reads
    looped, EOF is ConnectionError mid-structure)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def until(self, sep: bytes) -> bytes:
        while sep not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("peer closed mid-structure")
            self.buf += chunk
        out, self.buf = self.buf.split(sep, 1)
        return out

    def exactly(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("peer closed mid-structure")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out


def stream_generate(addr: Tuple[str, int], prompt, max_new: int, *,
                    sampling: Optional[dict] = None,
                    deadline_ms: Optional[float] = None,
                    timeout_s: float = 60.0,
                    abort_after_tokens: Optional[int] = None,
                    clock=time.monotonic) -> StreamResult:
    """One streamed generation against the HTTP edge, measured
    client-side: TTFT from request-sent to first token chunk, gaps
    between token arrivals (a k-token chunk spreads its arrival gap
    over its k tokens). `abort_after_tokens` closes the socket
    mid-stream after that many tokens — the disconnect-chaos client."""
    body = {"prompt": [int(t) for t in np.asarray(prompt).ravel()],
            "max_new": int(max_new)}
    if sampling is not None:
        body["sampling"] = sampling
    blob = json.dumps(body).encode()
    head = (f"POST /v1/generate HTTP/1.1\r\nHost: edge\r\n"
            f"Content-Length: {len(blob)}\r\n")
    if deadline_ms is not None:
        head += f"X-Deadline-Ms: {deadline_ms:g}\r\n"
    sock = socket.create_connection(addr, timeout=timeout_s)
    try:
        t0 = clock()
        sock.sendall(head.encode() + b"\r\n" + blob)
        rd = _Reader(sock)
        status_line = rd.until(b"\r\n").decode("latin-1")
        status = int(status_line.split(" ")[1])
        headers: Dict[str, str] = {}
        for line in rd.until(b"\r\n\r\n").decode("latin-1"
                                                 ).splitlines():
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        res = StreamResult(status=status,
                           retry_after=headers.get("retry-after"))
        if headers.get("transfer-encoding") != "chunked":
            n = int(headers.get("content-length", 0))
            payload = json.loads(rd.exactly(n).decode()) if n else {}
            res.outcome = payload.get("outcome")
            res.tokens = [int(t) for t in payload.get("tokens", [])]
            res.error = payload.get("error")
            return res
        last = None
        while True:
            size = int(rd.until(b"\r\n").decode("latin-1"), 16)
            if size == 0:
                break
            chunk = rd.exactly(size)
            rd.exactly(2)           # the chunk's trailing CRLF
            now = clock()
            for line in chunk.decode().splitlines():
                if not line.strip():
                    continue
                obj = json.loads(line)
                if obj.get("done"):
                    res.outcome = obj.get("outcome")
                    res.error = obj.get("error")
                    continue
                fresh = [int(t) for t in obj.get("tokens", [])]
                if fresh:
                    if last is None:
                        res.ttft_s = now - t0
                    else:
                        res.gaps_s.extend(
                            [(now - last) / len(fresh)] * len(fresh))
                    last = now
                    res.tokens.extend(fresh)
            if (abort_after_tokens is not None
                    and len(res.tokens) >= abort_after_tokens):
                res.aborted = True
                return res          # finally: closes the socket = FIN
        return res
    finally:
        try:
            sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# load generators


def closed_loop(addr: Tuple[str, int], shape: TrafficShape, *,
                users: int = 4, requests_per_user: int = 4,
                think_s: float = 0.0, seed: int = 0,
                deadline_ms: Optional[float] = None,
                timeout_s: float = 60.0) -> List[StreamResult]:
    """N users, each serially: send → stream to completion → think →
    repeat. Self-limiting, so the latency numbers are honest."""
    results: List[StreamResult] = []
    lock = threading.Lock()

    def user(uid: int) -> None:
        rng = np.random.RandomState(seed * 10007 + uid)
        for _ in range(requests_per_user):
            prompt, max_new = shape.sample(rng)
            try:
                r = stream_generate(addr, prompt, max_new,
                                    deadline_ms=deadline_ms,
                                    timeout_s=timeout_s)
            except (ConnectionError, OSError, ValueError) as e:
                r = StreamResult(status=0, error=repr(e))
            with lock:
                results.append(r)
            if think_s:
                time.sleep(think_s)

    threads = [threading.Thread(target=user, args=(u,), daemon=True)
               for u in range(users)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s * (requests_per_user + 1))
    return results


def open_loop(addr: Tuple[str, int], shape: TrafficShape, *,
              phases: Sequence[Tuple[float, int]],
              seed: int = 0, deadline_ms: Optional[float] = None,
              timeout_s: float = 60.0) -> List[StreamResult]:
    """Arrival-schedule load: `phases` is a ramp of `(qps, n)` steps;
    each request fires AT ITS SCHEDULED TIME regardless of earlier
    completions (the discipline that exposes overload). Returns one
    StreamResult per scheduled arrival."""
    rng = np.random.RandomState(seed * 30011)
    results: List[Optional[StreamResult]] = []
    threads: List[threading.Thread] = []
    lock = threading.Lock()

    def fire(idx: int, prompt, max_new) -> None:
        try:
            r = stream_generate(addr, prompt, max_new,
                                deadline_ms=deadline_ms,
                                timeout_s=timeout_s)
        except (ConnectionError, OSError, ValueError) as e:
            r = StreamResult(status=0, error=repr(e))
        with lock:
            results[idx] = r

    start = time.monotonic()
    offset = 0.0
    for qps, n in phases:
        for i in range(n):
            at = start + offset + i / float(qps)
            wait = at - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            prompt, max_new = shape.sample(rng)
            with lock:
                idx = len(results)
                results.append(None)
            t = threading.Thread(target=fire,
                                 args=(idx, prompt, max_new),
                                 daemon=True)
            t.start()
            threads.append(t)
        offset += n / float(qps)
    for t in threads:
        t.join(timeout=timeout_s)
    return [r if r is not None else StreamResult(status=0,
                                                 error="no result")
            for r in results]


# ---------------------------------------------------------------------------
# the SLO report


def _pct(sorted_xs: List[float], q: float) -> Optional[float]:
    if not sorted_xs:
        return None
    idx = min(len(sorted_xs) - 1, int(q * len(sorted_xs)))
    return float(sorted_xs[idx])


def slo_report(results: Sequence[StreamResult],
               wall_s: float) -> Dict[str, object]:
    """The edge SLO rollup: sustained QPS (completed streams per wall
    second) with client-measured p50/p99 time-to-first-token and
    p50/p99 inter-token gap, plus the shed/refusal tallies — the
    numbers `bench.py --edge-only` emits through the obs registry."""
    completed = [r for r in results if r.outcome == "completed"]
    ttfts = sorted(r.ttft_s for r in completed
                   if r.ttft_s is not None)
    gaps = sorted(g for r in completed for g in r.gaps_s)
    return {
        "requests": len(results),
        "completed": len(completed),
        "shed_429": sum(r.status == 429 for r in results),
        "shed_503": sum(r.status == 503 for r in results),
        "rejected_400": sum(r.status == 400 for r in results),
        "client_errors": sum(r.status == 0 for r in results),
        "other_outcomes": sum(r.status == 200
                              and r.outcome != "completed"
                              for r in results),
        "sustained_qps": len(completed) / max(wall_s, 1e-9),
        "tokens_streamed": sum(len(r.tokens) for r in results),
        "p50_ttft_s": _pct(ttfts, 0.50),
        "p99_ttft_s": _pct(ttfts, 0.99),
        "p50_itg_s": _pct(gaps, 0.50),
        "p99_itg_s": _pct(gaps, 0.99),
    }
