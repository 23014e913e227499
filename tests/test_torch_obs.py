"""The port's copies of the framework-free obs layer and shared-memory
arena held against the originals: one scripted sequence of operations
on each (injected clocks) must leave the same books -- registry
snapshots and both exporters, tracer counters and spans, flight rings
and dumps, arena tickets, counters and ledgers -- and the chaos audit
of tests/test_obs.py (a replica killed mid-burst under full
instrumentation) must give the same spans, counters and dump on both
serving stacks."""

import itertools
import json
import os

import numpy as np
import pytest

from paddle_tpu import obs as j_obs
from paddle_tpu.serve import shm_arena as j_shm
from paddle_tpu_torch import obs as t_obs
from paddle_tpu_torch.serve import shm_arena as t_shm
from torch_serving import (JAX, engine_cache, family_prompts, run_both,
                           warm_engines)

pytestmark = pytest.mark.obs

ENGINE = engine_cache()


def _engine(side, i):
    return ENGINE(side, f"o{i}", slots=2, max_len=32, page_size=4)


@pytest.fixture(scope="module")
def warm():
    warm_engines(JAX, [_engine(JAX, i) for i in range(3)], (11,),
                 buckets=(16,))


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _obs_script(obs, tmp):
    """Every public operation of the three pieces, in one sequence."""
    clk = Clock()
    reg = obs.MetricsRegistry(clock=clk, max_series_per_metric=4)
    c = reg.counter("reqs_total", "requests")
    g = reg.gauge("queue_depth", "queued")
    h = reg.histogram("latency_s", "latency", buckets=(0.1, 1.0))
    c.inc()
    c.inc(2, labels={"outcome": "completed"})
    for i in range(9):
        c.inc(labels={"req": str(i)})          # past the cardinality bound
    g.set(7)
    g.set(1.5, labels={"shard": "0"})
    h.observe(0.05)
    h.observe(5.0)
    books = {"completed": 3, "alive": True, "note": "text"}
    reg.register_source("srv", lambda: dict(books))

    def bad():
        raise RuntimeError("source died")

    reg.register_source("bad", bad)
    try:
        reg.gauge("reqs_total", "")
        kind_change = None
    except TypeError as e:
        kind_change = str(e)
    flight = obs.FlightRecorder(capacity=5, clock=clk)
    tr = obs.Tracer(clock=clk, sink=flight.note_span)
    span = tr.start("rr1", "fleet.request", rr_id=1)
    clk.advance(0.5)
    span.event("admitted", replica=2)
    again = tr.start("rr1", "fleet.request")
    tr.end("rr1", "completed", replica=2)
    tr.end(span, "failed")
    span.event("straggler")
    tr.start("rr2", "x")
    clk.advance(0.25)
    tr.end("rr2", "shed", error="load shed")
    for i in range(7):
        flight.record("pool", "admit", seq=i)
    path = flight.dump(str(tmp), "replica-death-r1",
                       extra={"counters": {"requests": 5}})
    with open(path) as f:
        dump = json.load(f)
    return dict(
        snapshot=reg.snapshot(), prom=reg.to_prometheus(),
        jsonl=reg.to_jsonl(), kind_change=kind_change,
        respan=again is span, duration=span.duration(),
        tracer=tr.counters(), outcomes=tr.terminal_outcomes(),
        tally=tr.outcome_counts(),
        spans=[(s.trace_id, s.outcome, s.events) for s in tr.finished],
        events=flight.events(), flight=flight.counters(),
        dump=dump, dump_name=os.path.basename(path),
        sanitized=[repr(obs.sanitize_value(v))
                   for v in (3, 2.5, True, "x", None, float("nan"))])


def test_obs_copies_match_the_originals(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    ref = _obs_script(j_obs, tmp_path / "j")
    got = _obs_script(t_obs, tmp_path / "t")
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == ref[k], k
    assert got["snapshot"]["dropped_series"] > 0
    assert got["tracer"]["double_ends"] == 1


def _arena_script(shm, name):
    arena = shm.ShmArena(name, seg_size=256, n_segs=8)
    try:
        tk1 = arena.scatter([b"hello, pages",
                             np.arange(100, dtype=np.int32).tobytes()])
        tk2 = arena.scatter([np.ones(20, np.float32).tobytes()])
        back = [bytes(m) for m in arena.gather(tk1)]
        arena.adopt(tk2)
        live = sorted(arena.live_tags(os.getpid()))
        full = None
        try:
            arena.scatter([b"x" * 4096])
        except shm.ArenaFull as e:
            full = type(e).__name__
        freed = arena.free(tk1)
        stale = None
        try:
            arena.gather(tk1)
        except shm.ArenaError as e:
            stale = type(e).__name__
        arena.free(tk2)
        arena.reconcile()
        strip = lambda t: {k: v for k, v in t.items() if k != "arena"}
        return dict(tickets=[strip(tk1), strip(tk2)], back=back, live=live,
                    full=full, freed=freed, stale=stale,
                    counters=arena.counters(), segs=arena.segments_live())
    finally:
        arena.close(destroy=True)


def test_shm_arena_copy_matches_the_original(monkeypatch):
    """Each module draws its scatter tags from a module-level counter:
    an earlier scatter in the same process would shift one module's
    count, so both start each script from a fresh counter."""
    tag = os.urandom(3).hex()
    monkeypatch.setattr(j_shm, "_TAG_COUNTER", itertools.count(1))
    ref = _arena_script(j_shm, f"pt-arena-j-{tag}")
    monkeypatch.setattr(t_shm, "_TAG_COUNTER", itertools.count(1))
    got = _arena_script(t_shm, f"pt-arena-t-{tag}")
    assert got == ref
    assert got["back"][0] == b"hello, pages" and got["freed"] > 0


def test_the_copies_share_the_arena_format():
    """An arena made by one module is attached and read by the other:
    the copy keeps the JAX module's shared-memory layout."""
    a = t_shm.ShmArena(seg_size=128, n_segs=4)
    try:
        tk = a.scatter([b"kv pages", b"more"])
        other = j_shm.ShmArena(a.name, create=False)
        assert [bytes(m) for m in other.gather(tk)] == [b"kv pages", b"more"]
        other.close()
        a.free(tk)
    finally:
        a.close(destroy=True)


def test_chaos_span_audit_matches_jax(tmp_path, warm):
    """tests/test_obs.py's audit on both stacks: replica 0 dies at a
    decode step mid-burst with tracer, flight recorder and registry
    on."""
    def scenario(side):
        obs = j_obs if side.name == "jax" else t_obs
        d = tmp_path / side.name
        d.mkdir()
        clk = side.ManualClock()
        registry = obs.MetricsRegistry(clock=clk)
        flight = obs.FlightRecorder(clock=clk)
        tracer = obs.Tracer(clock=clk, sink=flight.note_span)
        plan = side.FaultPlan()
        servers = []
        for i in range(3):
            eng = _engine(side, i)
            if i == 0:
                eng = plan.wrap_replica_engine(eng, clock=clk)
            servers.append(side.ServingServer(
                eng, max_queue=16, clock=clk, buckets=(16,),
                max_retries=2, tracer=tracer, flight=flight))
        router = side.ServingRouter(servers, clock=clk, tracer=tracer,
                                    flight=flight, flight_dir=str(d))
        router.bind_metrics(registry)
        plan.router_kill_decode_at = plan._router_decode_counter + 4
        for p in family_prompts(9, seed=12):
            router.submit(p, max_new=4)
        for g in side.garbage_prompts(61, 16).values():
            with pytest.raises(ValueError):
                router.submit(g, max_new=2)
        router.run()
        router.reconcile()
        (dump,) = [f for f in os.listdir(d)
                   if f.startswith("flight-replica-death")]
        with open(d / dump) as f:
            payload = json.load(f)
        series = {s["name"]: s["value"]
                  for s in registry.snapshot()["series"]}
        return dict(
            results=dict(router.results), counters=router.counters(),
            fired=list(plan.fired), tracer=tracer.counters(),
            outcomes=tracer.terminal_outcomes(),
            spans=[(s.trace_id, s.outcome, [e["name"] for e in s.events])
                   for s in tracer.finished],
            series=series,
            dump=(payload["reason"], payload["extra"]["counters"],
                  [(e["kind"], e.get("name")) for e in payload["events"]]))

    got = run_both(scenario, router=True)
    assert got["counters"]["replicas_lost"] == 1
    assert got["tracer"]["double_ends"] == 0
    assert all(len(v) == 1 for v in got["outcomes"].values())
