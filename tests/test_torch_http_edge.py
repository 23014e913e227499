"""The port's HTTP front door (`serve.http_edge.HttpEdge`) held against the
JAX package's, case by case of tests/test_http_edge.py: each case runs
one edge per package over a one-replica router on the shared TINY
weights, drives it over real sockets with the port's traffic client, and
the statuses, streamed tokens, outcomes and edge counters must be equal
(and the tokens equal to the JAX engine's greedy decode). The CTR route,
`POST /v1/ctr/score`, is held over each package's `CtrServer` on one
tower, scores within 1e-6.

The cases that race a client against the decode are made deterministic
with a gated drive loop (`Gate`): the edge's drive thread sweeps only
when the test grants a sweep and parks unlocked otherwise, so the stream
threads are never starved of the edge lock, a disconnect lands before
the request can finish, and overload meets a queue that provably cannot
drain. (A sleep inside the sweep, as the JAX suite throttles it, holds
the edge lock across the sleep: its stream thread can then starve until
the request completes, and the JAX disconnect case fails run alone on
this CPU.)"""

import json
import socket
import threading
import time

import numpy as np
import pytest

from paddle_tpu.obs import MetricsRegistry as JRegistry
from paddle_tpu.serve.ctr import CtrServer as JCtrServer
from paddle_tpu.serve.embed_cache import TieredEmbedCache as JCache
from paddle_tpu_torch.obs import MetricsRegistry as TRegistry
from paddle_tpu_torch.serve import CtrServer, TieredEmbedCache, init_tower
from paddle_tpu_torch.testing.traffic import stream_generate
from torch_fleet import JAX, SIDES, TORCH, await_true, engine, jax_tokens

pytestmark = [pytest.mark.edge, pytest.mark.faults]

REGISTRY = {"jax": JRegistry, "torch": TRegistry}


@pytest.fixture(scope="module", autouse=True)
def warm():
    engine(JAX).serve([np.arange(5, dtype=np.int32)], max_new=2,
                             buckets=(16,))


def mk_stack(side, *, max_queue=16, registry=False, **edge_kw):
    """engine -> server -> 1-replica router -> started edge, fresh
    books per case (the engine is shared: a server resets its pool)."""
    srv = side.ServingServer(engine(side), max_queue=max_queue,
                             buckets=(16,))
    router = side.ServingRouter([srv])
    if registry:
        edge_kw["registry"] = REGISTRY[side.name]()
    edge = side.HttpEdge(router, **edge_kw).start()
    return edge, router, srv


def wait_idle(edge, router, timeout_s=20.0):
    """Sweep (under the edge's lock: the drive thread sweeps too) until
    no stream is active and the fleet is idle."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if edge.counters()["active_streams"] == 0:
            with edge._lock:
                if not router.sweep():
                    return True
        time.sleep(0.02)
    return False


def raw_exchange(addr, blob, timeout_s=5.0):
    """Send raw bytes, read to EOF -- the malformed-input client."""
    with socket.create_connection(addr, timeout=timeout_s) as s:
        s.sendall(blob)
        out = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return out
            out += chunk


def status_of(raw):
    return int(raw.split(b"\r\n", 1)[0].split(b" ")[1])


def post(target, payload, extra=""):
    blob = json.dumps(payload).encode()
    return (f"POST {target} HTTP/1.1\r\nHost: e\r\n{extra}"
            f"Content-Length: {len(blob)}\r\n\r\n").encode() + blob


class Gate:
    """The edge's drive loop, sweeping only what the test grants: a
    refused sweep reports idle, so the drive thread parks WITHOUT the
    edge lock and the stream threads snapshot and write freely."""

    def __init__(self, edge):
        self._sweep = edge._sweep_fn
        self._permits = 0
        self._open = False
        self._lock = threading.Lock()
        self.depth = 0
        edge._sweep_fn = self.sweep

    def sweep(self):
        with self._lock:
            if not self._open:
                if self._permits == 0:
                    return False
                self._permits -= 1
        return self._sweep()

    def grant(self, n=1, settle_s=0.05):
        """Allow n more sweeps, wait until the drive loop took them,
        then give the stream threads `settle_s` to write."""
        with self._lock:
            self._permits += n
        deadline = time.monotonic() + 10.0
        while self._permits and time.monotonic() < deadline:
            time.sleep(0.002)
        time.sleep(settle_s)

    def open(self):
        with self._lock:
            self._open = True


def on_both(case):
    """Run `case(side, edge, router, srv)` on a fresh stack per package
    (closed after); returns the (jax, port) pair of what it returned."""
    out = []
    for side in SIDES:
        edge, router, srv = mk_stack(side, **case.stack_kw)
        try:
            out.append(case(side, edge, router, srv))
        finally:
            edge.close()
    return tuple(out)


def stack(**kw):
    def deco(fn):
        fn.stack_kw = kw
        return fn
    return deco


def test_stream_parity_and_nonstream():
    """Chunked streaming hands over exactly the greedy decode, in order;
    `stream: false` returns the same tokens in one JSON body; TTFT lands
    in the bound histogram."""
    prompt = [1, 2, 3, 4, 5]

    @stack(registry=True)
    def case(side, edge, router, srv):
        r = stream_generate(edge.addr, prompt, 6)
        raw = raw_exchange(edge.addr, post("/v1/generate", {
            "prompt": prompt, "max_new": 6, "stream": False}))
        body = json.loads(raw.split(b"\r\n\r\n", 1)[1])
        snap = {s["name"] for s in edge._registry.snapshot()["series"]}
        return (r.status, r.outcome, r.tokens, r.ttft_s is not None,
                status_of(raw), body,
                "edge_ttft_seconds_bucket" in snap, "edge_requests" in snap,
                edge.counters())

    ref, got = on_both(case)
    assert got == ref
    assert got[:4] == (200, "completed", jax_tokens(prompt, 6), True)
    assert got[5]["tokens"] == got[2] and got[5]["n_tokens"] == 6
    assert got[6] and got[7]
    assert got[8]["requests"] == 2 == got[8]["completed"]


def test_stream_bit_exact_across_many_chunks():
    """Throttled steps force the stream through many snapshot/write
    cycles; the concatenation of every chunk is still the greedy
    decode."""
    prompt = [2, 4, 6]

    @stack()
    def case(side, edge, router, srv):
        gate = Gate(edge)
        got = {}
        t = threading.Thread(target=lambda: got.update(
            r=stream_generate(edge.addr, prompt, 8)), daemon=True)
        t.start()
        while t.is_alive() and edge.counters()["requests"] < 1:
            time.sleep(0.005)
        while t.is_alive():
            gate.grant(1, settle_s=0.02)
        r = got["r"]
        return (r.status, r.outcome, r.tokens, any(g > 0 for g in r.gaps_s),
                wait_idle(edge, router))

    ref, got = on_both(case)
    assert got == ref == (200, "completed", jax_tokens(prompt, 8), True,
                          True)


def test_healthz_and_metrics():
    @stack(registry=True)
    def case(side, edge, router, srv):
        raw = raw_exchange(edge.addr,
                           b"GET /healthz HTTP/1.1\r\nHost: e\r\n\r\n")
        health = (status_of(raw), json.loads(raw.split(b"\r\n\r\n", 1)[1]))
        stream_generate(edge.addr, [1, 2, 3], 2)
        raw = raw_exchange(edge.addr,
                           b"GET /metrics HTTP/1.1\r\nHost: e\r\n\r\n")
        return (health, status_of(raw), b"edge_connections" in raw,
                b"edge_ttft_seconds_bucket" in raw)

    ref, got = on_both(case)
    assert got == ref
    assert got == ((200, {"draining": False, "queue_space": 16,
                          "active_streams": 0}), 200, True, True)


MALFORMED = [
    b"NONSENSE\r\n\r\n",
    b"GET /nope HTTP/1.1\r\nHost: e\r\n\r\n",
    b"GET /v1/generate HTTP/1.1\r\nHost: e\r\n\r\n",
    b"POST /v1/generate HTTP/1.1\r\nHost: e\r\n\r\n",
    b"POST /v1/generate HTTP/1.1\r\nHost: e\r\nContent-Length: zero\r\n\r\n",
    # declared body over the cap: refused BEFORE a byte is read
    b"POST /v1/generate HTTP/1.1\r\nHost: e\r\nContent-Length: 99999\r\n\r\n",
    # header block over the cap: refused as it accumulates
    b"GET /healthz HTTP/1.1\r\n" + b"X-Filler: " + b"a" * 4096 + b"\r\n\r\n",
    b"POST /v1/generate HTTP/1.1\r\nHost: e\r\nContent-Length: 9\r\n\r\n"
    b"not json!",
    b"POST /v1/generate HTTP/1.1\r\nHost: e\r\nContent-Length: 13\r\n\r\n"
    b"{\"prompt\": 3}",
    # the CTR route with no backend bound
    b"POST /v1/ctr/score HTTP/1.1\r\nHost: e\r\nContent-Length: 2\r\n\r\n{}",
]


def test_malformed_never_touch_the_fleet():
    """Every malformed, oversized or unknown request is answered in-band
    with the same status by both edges, and the router's admission
    ledger never hears about any of them."""
    @stack(max_header_bytes=512, max_body_bytes=256)
    def case(side, edge, router, srv):
        statuses = [status_of(raw_exchange(edge.addr, r))
                    for r in MALFORMED]
        return (statuses, router.counters()["requests"],
                edge.counters()["requests"],
                edge.counters()["malformed_400"])

    ref, got = on_both(case)
    assert got == ref
    assert got[0] == [400, 404, 405, 411, 400, 413, 431, 400, 400, 404]
    assert got[1:3] == (0, 0) and got[3] > 0


def test_slow_loris_closed_on_timeout_alone():
    @stack(header_timeout_s=0.2, body_timeout_s=0.2)
    def case(side, edge, router, srv):
        closed = []
        with socket.create_connection(edge.addr, timeout=5.0) as s:
            s.sendall(b"POST /v1/generate HTTP/1.1\r\n")  # ...stall...
            closed.append(s.recv(4096) == b"")
        with socket.create_connection(edge.addr, timeout=5.0) as s:
            s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: e\r\n"
                      b"Content-Length: 64\r\n\r\n{\"pro")
            closed.append(s.recv(4096) == b"")
        return (closed, edge.counters()["hangups"],
                router.counters()["requests"])

    ref, got = on_both(case)
    assert got == ref == ([True, True], 2, 0)


def test_deadline_header_expires_request():
    """X-Deadline-Ms rides the submit into the fleet's deadline
    machinery: a budget far below the decode ends `expired`; a
    malformed header answers 400."""
    @stack()
    def case(side, edge, router, srv):
        r = stream_generate(edge.addr, [1, 2, 3], 12, deadline_ms=0.01)
        raw = raw_exchange(edge.addr, post(
            "/v1/generate", {"prompt": [1], "max_new": 2},
            extra="X-Deadline-Ms: soon\r\n"))
        return r.status, r.outcome, len(r.tokens) < 12, status_of(raw)

    ref, got = on_both(case)
    assert got == ref == (200, "expired", True, 400)


def test_disconnect_mid_stream_frees_slot_and_pages():
    """A client vanishing mid-stream costs the fleet nothing durable:
    the request is force-expired, its slot and pages free, the books
    reconcile, and the next client is served normally."""
    @stack()
    def case(side, edge, router, srv):
        gate = Gate(edge)
        got = {}
        t = threading.Thread(target=lambda: got.update(r=stream_generate(
            edge.addr, [1, 2, 3, 4], 12, abort_after_tokens=2)),
            daemon=True)
        t.start()
        while t.is_alive():
            gate.grant(1)
        # the client left; the request cannot finish while no sweep runs
        assert await_true(lambda: edge.counters()["disconnect_cancels"])
        gate.open()
        r = got["r"]
        idle = wait_idle(edge, router)
        c = edge.counters()
        (_, res), = router.results.items()
        router.reconcile()
        srv.reconcile()
        pool = srv.engine.pool
        r2 = stream_generate(edge.addr, [9, 8, 7], 4)
        return (r.aborted, len(r.tokens) >= 2, idle,
                c["disconnect_cancels"], c["active_streams"], res.outcome,
                len(res.tokens) < 12, pool.pages_in_use - pool.evictable(),
                all(q is None for q in srv._slot_req), r2.outcome,
                r2.tokens)

    ref, got = on_both(case)
    assert got == ref
    assert got == (True, True, True, 1, 0, "expired", True, 0, True,
                   "completed", jax_tokens([9, 8, 7], 4))


def test_disconnect_while_queued_cancels_before_decode():
    """A client that vanishes while its request is still QUEUED (both
    slots busy) is cancelled before it ever takes a slot."""
    @stack()
    def case(side, edge, router, srv):
        gate = Gate(edge)
        holders = [threading.Thread(
            target=stream_generate, args=(edge.addr, [1, 2, 3 + i], 10),
            daemon=True) for i in range(2)]
        for t in holders:
            t.start()
        await_true(lambda: edge.counters()["requests"] >= 2)
        gate.grant(1)               # both holders take the two slots
        s = socket.create_connection(edge.addr, timeout=5.0)
        s.sendall(post("/v1/generate", {"prompt": [4, 5, 6],
                                        "max_new": 10}))
        await_true(lambda: edge.counters()["requests"] >= 3)
        admitted = edge.counters()["requests"]
        queued = len(srv.queue)
        s.close()                   # the queued client vanishes
        cancelled = await_true(
            lambda: edge.counters()["disconnect_cancels"] == 1)
        gate.open()
        for t in holders:
            t.join(timeout=20.0)
        idle = wait_idle(edge, router)
        router.reconcile()
        srv.reconcile()
        (_, res), = [(k, v) for k, v in router.results.items()
                     if v.outcome != "completed"]
        return (admitted, queued, cancelled, idle,
                edge.counters()["disconnect_cancels"], res.outcome,
                len(res.tokens), router.counters()["completed"])

    ref, got = on_both(case)
    assert got == ref == (3, 1, True, True, 1, "expired", 0, 2)


def test_overload_sheds_429_with_the_queue_bounded():
    """A full admission queue sheds 429 + Retry-After AT THE EDGE and
    the queue never grows past its bound; once the drive loop runs
    again every admitted request completes. Deterministic: the drive
    loop is held (sweeps nothing) while the queue fills."""
    @stack(max_queue=3)
    def case(side, edge, router, srv):
        gate = Gate(edge)
        admitted = [None] * 3

        def client(i):
            admitted[i] = stream_generate(edge.addr, [1, 2, 3 + i], 4)

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        while (time.monotonic() < deadline
               and edge.counters()["requests"] < 3):
            time.sleep(0.01)
        depth = len(srv.queue)
        shed = [stream_generate(edge.addr, [7, 7, i], 4) for i in range(3)]
        depth = max(depth, len(srv.queue))
        gate.open()
        for t in threads:
            t.join(timeout=20.0)
        idle = wait_idle(edge, router)
        router.reconcile()
        return ([r.status for r in shed],
                all(r.retry_after is not None for r in shed),
                [(r.status, r.outcome, r.tokens) for r in admitted],
                depth, idle, edge.counters()["shed_429"],
                router.counters()["completed"])

    ref, got = on_both(case)
    assert got == ref
    assert got[0] == [429] * 3 and got[1]
    assert [a[:2] for a in got[2]] == [(200, "completed")] * 3
    assert [a[2] for a in got[2]] == [jax_tokens([1, 2, 3 + i], 4)
                                      for i in range(3)]
    assert got[3] == 3 and got[4] and got[5] == 3 and got[6] == 3


def test_drain_503_in_flight_finishes_report_lands(tmp_path):
    """drain() stops admission (newcomers answer 503 + Retry-After),
    the in-flight stream runs to its natural end, wait_drained() goes
    idle and the drain report lands."""
    def case(side, edge, router, srv):
        got = {}

        def one():
            got["inflight"] = stream_generate(edge.addr, [1, 2, 3], 8)

        gate = Gate(edge)
        t = threading.Thread(target=one, daemon=True)
        t.start()
        await_true(lambda: edge.counters()["requests"] >= 1)
        gate.grant(1)               # in flight: prefilled, decoding
        edge.drain(reason="test drain")
        late = stream_generate(edge.addr, [4, 5], 2)
        gate.open()
        t.join(timeout=20.0)
        drained = edge.wait_drained(timeout_s=20.0)
        report = json.loads(open(edge.drain_report_path).read())
        return (late.status, late.retry_after is not None,
                got["inflight"].outcome, got["inflight"].tokens, drained,
                report["kind"], report["reason"], report["edge"],
                report["fleet"]["completed"])

    out = []
    for side in SIDES:
        path = tmp_path / f"drain_{side.name}.json"
        edge, router, srv = mk_stack(side, drain_report_path=str(path))
        try:
            out.append(case(side, edge, router, srv))
        finally:
            edge.close()
    ref, got = out
    assert got == ref
    assert got[:7] == (503, True, "completed", jax_tokens([1, 2, 3], 8),
                       True, "edge_drain_report", "test drain")
    assert got[7]["shed_503"] == 1 and got[8] >= 1


class Backing:
    """A CTR table that serves row `r` as `r * 10 + j` over a 4-wide
    embedding, with no watermarks (a static table)."""

    dim, vocab, n_shards = 4, 64, 1

    def pull_rows(self, table, ids):
        ids = np.asarray(ids).reshape(-1)
        rows = (10.0 * ids[:, None] + np.arange(self.dim)[None, :]) / 100.0
        return rows.astype(np.float32), None

    def owner_of(self, ids):
        ids = np.asarray(ids).reshape(-1)
        return np.where((ids < 0) | (ids >= self.vocab), -1, 0)

    def poll_watermarks(self, table):
        return None

    def shard_failovers(self):
        return [0]


def test_ctr_score_route_matches_jax():
    """POST /v1/ctr/score over each package's CtrServer (one tower, one
    backing): scores within 1e-6, the same batch, malformed bodies 400,
    a GET 405, and the edge's ctr_requests count."""
    tower = init_tower(1, Backing.dim)
    reqs = [{"ids": [[1, 2, 3, -1], [5, 6, -1, -1]]},
            {"ids": [[30, 31, 7, 7]]}]
    out = {}
    for side in SIDES:
        if side is JAX:
            ctr = JCtrServer(JCache(Backing(), hot_rows=16, host_rows=24),
                             tower, slots=4, max_batch=2)
        else:
            ctr = CtrServer(TieredEmbedCache(Backing(), hot_rows=16,
                                             host_rows=24, device="cpu"),
                            tower, slots=4, max_batch=2, device="cpu")
        edge, router, srv = mk_stack(side, ctr=ctr)
        try:
            bodies = []
            for payload in reqs:
                raw = raw_exchange(edge.addr, post("/v1/ctr/score", payload))
                assert status_of(raw) == 200, raw
                bodies.append(json.loads(raw.split(b"\r\n\r\n", 1)[1]))
            bad = [status_of(raw_exchange(edge.addr, r)) for r in (
                post("/v1/ctr/score", {"not_ids": 1}),
                post("/v1/ctr/score", [1]),
                b"POST /v1/ctr/score HTTP/1.1\r\nHost: e\r\n"
                b"Content-Length: 4\r\n\r\nnope",
                b"GET /v1/ctr/score HTTP/1.1\r\nHost: e\r\n\r\n")]
            out[side.name] = (bodies, bad, edge.counters()["ctr_requests"],
                              router.counters()["requests"])
        finally:
            edge.close()
    (jb, jbad, jn, jr), (tb, tbad, tn, tr) = out["jax"], out["torch"]
    assert (tbad, tn, tr) == (jbad, jn, jr) == ([400, 400, 400, 405], 2, 0)
    for a, b in zip(tb, jb):
        assert a["batch"] == b["batch"]
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0,
                                   atol=1e-6)


@pytest.mark.fleet
@pytest.mark.slow
@pytest.mark.heavyweight
def test_sigkill_replica_under_live_http_load(tmp_path):
    """Live HTTP streams over a 3-replica process fleet of the port
    while FaultPlan SIGKILLs one mid-burst: every stream ends in exactly
    one completed outcome with the JAX engine's tokens -- the edge's
    high-water mark makes the redistribution invisible on the wire."""
    from paddle_tpu_torch.testing.traffic import stream_generate as sg
    from torch_fleet import mk_prompts, tiny_spec

    sup = TORCH.FleetSupervisor(tiny_spec(tmp_path), min_replicas=3,
                                max_replicas=3)
    sup.start()
    # late-bound sweep: wrap_fleet replaces sup.sweep once streams live
    edge = TORCH.HttpEdge(sup.router, sweep_fn=lambda: sup.sweep(),
                          submit_fn=sup.submit,
                          drain_fn=lambda why: sup.drain(reason=why)).start()
    prompts = mk_prompts(8)
    results = [None] * len(prompts)
    try:
        def client(i):
            results[i] = sg(edge.addr, prompts[i], 8, timeout_s=120.0)

        gate = Gate(edge)
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        # every stream admitted before the fleet steps, then two sweeps
        # of decoding: the victim provably dies with streams in flight
        assert await_true(lambda: edge.counters()["requests"] == 8, 60.0)
        gate.grant(2)
        assert all(r.pending for r in sup.router.replicas)
        TORCH.FaultPlan(fleet_sigkill_at=0,
                        fleet_sigkill_replica=1).wrap_fleet(sup)
        gate.open()
        for t in threads:
            t.join(timeout=120.0)
        sup.reconcile()
        c = sup.router.counters()
        assert c["replicas_lost"] == 1 and c["redistributed"] >= 1
        assert c["completed"] == len(prompts)
        assert c["failed"] == 0 and c["shed"] == 0
        assert sup.counters()["procs_alive"] == 3
    finally:
        edge.close()
        sup.shutdown(drain=False)
    for p, r in zip(prompts, results):
        assert r.status == 200 and r.outcome == "completed"
        assert r.tokens == jax_tokens(p, 8)
