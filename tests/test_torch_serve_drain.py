"""The port's ServingServer against the JAX package's (continued from
test_torch_serve_server.py): graceful drain and SIGTERM, the circuit
breaker over a second backend, the mixed-burst chaos run, and the
speculative server -- each case of tests/test_serve_server.py (and the
speculative path it does not cover) run on both packages with the same
submissions, ManualClock and FaultPlan."""

import json
import os
import signal

import numpy as np
import pytest

from torch_serving import (JAX, engine_cache, prompts_rng, run_both,
                           warm_engines)

pytestmark = pytest.mark.faults

ENGINE = engine_cache()


def eng2(side):
    return ENGINE(side, "eng2", slots=2, max_len=32)


def eng1(side):
    return ENGINE(side, "eng1", slots=1, max_len=32)


def spec_engine(side, kv):
    return ENGINE(side, f"spec_{kv}", slots=2, max_len=32, page_size=4,
                  kv_cache_dtype=kv)


@pytest.fixture(scope="module", autouse=True)
def warm():
    warm_engines(JAX, [eng2(JAX)], (3, 4, 5, 6, 7, 9))
    warm_engines(JAX, [eng1(JAX)], (4, 5, 6))
    warm_engines(JAX, [eng2(JAX)], (5,), buckets=(16,))
    for kv in ("compute", "int8"):
        spec_engine(JAX, kv).serve([np.asarray([3, 7, 3, 7, 3, 7, 1])],
                                   max_new=4, buckets=(16,),
                                   speculative=True)


def _done(srv, *plans, **extra):
    srv.reconcile()
    return dict(results=dict(srv.results), counters=srv.counters(),
                fired=[list(p.fired) for p in plans], **extra)


def test_drain_finishes_in_flight_sheds_queue(tmp_path):
    def scenario(side):
        report = tmp_path / f"drain_{side.name}.json"
        srv = side.ServingServer(eng2(side), max_queue=8,
                                 clock=side.ManualClock(),
                                 drain_report_path=str(report))
        for p in prompts_rng(5, [5, 9, 3, 7, 4], seed=13):
            srv.submit(p, max_new=6)
        srv.on_step.append(
            lambda s, step: s.drain(reason="test") if step == 2 else None)
        srv.run()
        rep = json.loads(report.read_text())
        assert rep["counters"] == srv.counters()
        return _done(srv, report=rep)

    got = run_both(scenario)
    outs = [r.outcome for r in got["results"].values()]
    assert outs.count("completed") == 2 and outs.count("shed") == 3


def test_drain_grace_expires_stragglers():
    def scenario(side):
        clk = side.ManualClock()
        srv = side.ServingServer(eng2(side), max_queue=8, clock=clk,
                                 drain_grace_s=0.01)
        for p in prompts_rng(2, [5, 6], seed=14):
            srv.submit(p, max_new=30)

        def hook(s, step):
            if step == 2:
                s.drain(reason="grace")
            clk.advance(0.004)

        srv.on_step.append(hook)
        srv.run()
        return _done(srv)

    got = run_both(scenario)
    assert all(r.outcome == "expired" and "drain grace" in r.error
               for r in got["results"].values())


def test_sigterm_triggers_drain():
    def scenario(side):
        srv = side.ServingServer(eng1(side), max_queue=8,
                                 clock=side.ManualClock(),
                                 install_signal_handlers=True)
        for p in prompts_rng(3, [5, 6, 4], seed=15):
            srv.submit(p, max_new=5)
        srv.on_step.append(
            lambda s, step: os.kill(os.getpid(), signal.SIGTERM)
            if step == 1 else None)
        srv.run()
        return _done(srv, report=srv.drain_report)

    got = run_both(scenario)
    assert "signal" in got["report"]["reason"]
    assert [r.outcome for _, r in sorted(got["results"].items())] == [
        "completed", "shed", "shed"]


def test_submit_while_draining_is_shed():
    def scenario(side):
        srv = side.ServingServer(eng2(side), max_queue=8,
                                 clock=side.ManualClock())
        srv.drain(reason="pre")
        with pytest.raises(side.QueueFullError, match="draining"):
            srv.submit(prompts_rng(1, [4], seed=16)[0], max_new=2)
        srv.run()
        return _done(srv)

    assert run_both(scenario)["counters"]["shed"] == 1


def test_breaker_trips_to_fallback_and_recovers():
    """The native backend is the same engine under a fault wrapper: two
    bursts fail, the breaker opens, the primary engine ("torch" where
    JAX says "jax") serves; past the cooldown the probe closes it."""
    def scenario(side):
        clk = side.ManualClock()
        plan = side.FaultPlan(serve_error_first_n=2)
        native = plan.wrap_engine(eng2(side), clock=clk)
        breaker = side.CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                                      clock=clk)
        srv = side.ServingServer(eng2(side), native_backend=native,
                                 breaker=breaker, max_queue=16, clock=clk,
                                 max_retries=3)
        ps = prompts_rng(5, [5, 9, 3, 7, 4], seed=17)
        for p in ps[:3]:
            srv.submit(p, max_new=4)
        srv.run()
        srv.reconcile()
        first = (breaker.state, breaker.trips)
        clk.advance(2.0)
        for p in ps[3:]:
            srv.submit(p, max_new=4)
        srv.run()
        return _done(srv, plan, first=first, state=breaker.state)

    got = run_both(scenario)
    assert got["first"] == ("open", 1) and got["state"] == "closed"
    backends = [r.backend for _, r in sorted(got["results"].items())]
    assert backends == ["torch"] * 3 + ["native"] * 2


def test_failed_probe_reopens():
    def scenario(side):
        clk = side.ManualClock()
        br = side.CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                                 clock=clk)
        trace = []
        for step in ("f", "f", "a", "t", "a", "f", "a", "t", "a", "s"):
            if step == "f":
                br.record_failure()
            elif step == "s":
                br.record_success()
            elif step == "t":
                clk.advance(1.5)
            else:
                trace.append(br.allow())
            trace.append((br.state, br.trips))
        return dict(trace=trace)

    assert run_both(scenario)["trace"][-1] == ("closed", 1)


def test_mixed_burst_reconciles_and_keeps_serving():
    """The chaos run: queue overflow, a deadline storm from an injected
    stall, garbage prompts and a native fault burst tripping the
    breaker, then a clean follow-up wave."""
    def scenario(side):
        clk = side.ManualClock()
        plan_native = side.FaultPlan(serve_error_first_n=2)
        plan_fb = side.FaultPlan(serve_stall_at=4, serve_stall_s=0.05)
        native = plan_native.wrap_engine(eng2(side), clock=clk)
        fallback = plan_fb.wrap_engine(eng2(side), clock=clk)
        breaker = side.CircuitBreaker(failure_threshold=2,
                                      cooldown_s=30.0, clock=clk)
        srv = side.ServingServer(fallback, native_backend=native,
                                 breaker=breaker, max_queue=4,
                                 max_retries=2, clock=clk, buckets=(16,))
        ps = prompts_rng(8, [5, 9, 3, 7, 4, 6, 8, 5], seed=18)
        sync = []
        for p, dl in zip(ps, [None, 20, None, 20, 20, None, 20, None]):
            try:
                srv.submit(p, max_new=6, deadline_ms=dl)
            except side.QueueFullError:
                sync.append("shed")
        for g in side.garbage_prompts(61, 16).values():
            try:
                srv.submit(g, max_new=4)
            except ValueError:
                sync.append("failed")
        srv.run()
        srv.reconcile()
        wave1 = srv.counters()
        for p in prompts_rng(3, [4, 6, 5], seed=19):
            srv.submit(p, max_new=4)
        srv.run()
        return _done(srv, plan_native, plan_fb, sync=sync, wave1=wave1,
                     trips=breaker.trips)

    got = run_both(scenario)
    c = got["wave1"]
    assert c["expired"] >= 1 and c["shed"] >= 1 and c["failed"] == 6
    assert got["trips"] == 1


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_speculative_server_matches_jax(kv):
    """speculative=True: drafts from the n-gram proposer, one verify
    round per step, the decode fault schedule striking a round."""
    def scenario(side):
        eng = spec_engine(side, kv)
        plan = side.FaultPlan(serve_decode_error_at=2)
        srv = side.ServingServer(plan.wrap_engine(eng), max_queue=8,
                                 clock=side.ManualClock(), buckets=(16,),
                                 speculative=True)
        base = [3, 7, 3, 7, 3, 7]
        for i, p in enumerate(prompts_rng(3, [4, 6, 5], seed=20)):
            srv.submit(base + list(p), max_new=8)
        srv.run()
        return _done(srv, plan)

    got = run_both(scenario)
    assert got["counters"]["spec_rounds"] > 0
    assert got["counters"]["draft_proposed"] > 0
