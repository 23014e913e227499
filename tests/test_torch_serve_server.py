"""The port's ServingServer held against the JAX package's, case by case
of tests/test_serve_server.py: admission and shedding, deadlines,
retry. Each case runs once on each package over its own engine (the
same weights), with the same submissions, ManualClock and FaultPlan;
results (outcome, tokens, error text, retries; logprobs within 1e-4),
counters and fired faults must be equal. The drain, breaker and chaos
cases are in test_torch_serve_drain.py."""

import pytest

from torch_serving import (JAX, engine_cache, prompts_rng, run_both,
                           warm_engines)

pytestmark = pytest.mark.faults

ENGINE = engine_cache()


@pytest.fixture(scope="module", autouse=True)
def warm():
    """Compile the JAX engines' prefill bodies (one per prompt length
    these cases use) and decode step once, outside the cases."""
    warm_engines(JAX, [eng1(JAX)], (3, 4, 5, 6, 7, 9, 12))
    warm_engines(JAX, [eng2(JAX)], (3, 5, 7, 9))


def eng2(side):
    return ENGINE(side, "eng2", slots=2, max_len=32)


def eng1(side):
    return ENGINE(side, "eng1", slots=1, max_len=32)


def _done(srv, plan=None, **extra):
    srv.reconcile()
    out = dict(results=dict(srv.results), counters=srv.counters(),
               stats=srv.stats.__dict__.copy(), **extra)
    if plan is not None:
        out["fired"] = list(plan.fired)
    return out


def test_completed_requests_match_jax():
    def scenario(side):
        srv = side.ServingServer(eng2(side), max_queue=8,
                                 clock=side.ManualClock())
        for p in prompts_rng(4, [5, 9, 3, 7], seed=1):
            srv.submit(p, max_new=10)
        srv.run()
        return _done(srv)

    got = run_both(scenario)
    assert all(r.outcome == "completed" for r in got["results"].values())


def test_queue_overflow_sheds_with_documented_error():
    def scenario(side):
        srv = side.ServingServer(eng1(side), max_queue=2,
                                 clock=side.ManualClock())
        srv.submit(prompts_rng(1, [9], seed=2)[0], max_new=2)
        srv.submit(prompts_rng(1, [7], seed=3)[0], max_new=2)
        with pytest.raises(side.QueueFullError, match="queue full"):
            srv.submit(prompts_rng(1, [3], seed=4)[0], max_new=2)
        srv.run()
        return _done(srv)

    got = run_both(scenario)
    assert got["counters"]["shed"] == 1
    assert got["counters"]["completed"] == 2


def test_overflow_displaces_cheapest_queued():
    def scenario(side):
        srv = side.ServingServer(eng1(side), max_queue=2,
                                 clock=side.ManualClock())
        srv.submit(prompts_rng(1, [9], seed=2)[0], max_new=2)
        small = srv.submit(prompts_rng(1, [3], seed=4)[0], max_new=2)
        big = srv.submit(prompts_rng(1, [12], seed=5)[0], max_new=2)
        srv.run()
        return _done(srv, ids=(small, big))

    got = run_both(scenario)
    small, big = got["ids"]
    assert got["results"][small].outcome == "shed"
    assert "displaced" in got["results"][small].error
    assert got["results"][big].outcome == "completed"


def test_garbage_prompts_rejected_pool_survives():
    def scenario(side):
        srv = side.ServingServer(eng1(side), max_queue=8, buckets=(8,),
                                 clock=side.ManualClock())
        errors = []
        for name, g in side.garbage_prompts(61, 8).items():
            with pytest.raises(ValueError) as e:
                srv.submit(g, max_new=2)
            errors.append(str(e.value))
        ok_prompt = prompts_rng(1, [4], seed=6)[0]
        with pytest.raises(ValueError, match="max_new"):
            srv.submit(ok_prompt, max_new=0)
        srv.submit(ok_prompt, max_new=3)
        srv.run()
        return _done(srv, errors=errors)

    got = run_both(scenario)
    assert got["counters"]["failed"] == 7 and got["stats"]["prefills"] == 1


def test_expiry_mid_decode_frees_slot_for_queued():
    def scenario(side):
        clk = side.ManualClock()
        srv = side.ServingServer(eng1(side), max_queue=8, clock=clk)
        ps = prompts_rng(2, [5, 9], seed=7)
        doomed = srv.submit(ps[0], max_new=50, deadline_ms=5)
        srv.submit(ps[1], max_new=4, deadline_ms=None)
        srv.on_step.append(lambda s, step: clk.advance(0.002))
        srv.run()
        return _done(srv, doomed=doomed)

    got = run_both(scenario)
    res = got["results"][got["doomed"]]
    assert res.outcome == "expired" and "mid-generation" in res.error
    assert 0 < len(res.tokens) < 50


def test_queued_expiry_costs_no_prefill():
    def scenario(side):
        clk = side.ManualClock()
        srv = side.ServingServer(eng1(side), max_queue=8, clock=clk)
        ps = prompts_rng(2, [5, 6], seed=8)
        srv.submit(ps[0], max_new=8)
        srv.submit(ps[1], max_new=8, deadline_ms=4)
        srv.on_step.append(lambda s, step: clk.advance(0.003))
        srv.run()
        return _done(srv)

    got = run_both(scenario)
    assert got["stats"]["prefills"] == 1
    assert got["counters"]["expired"] == 1


def test_default_deadline_applies():
    def scenario(side):
        clk = side.ManualClock()
        srv = side.ServingServer(eng1(side), max_queue=8, clock=clk,
                                 default_deadline_ms=5)
        srv.submit(prompts_rng(1, [5], seed=9)[0], max_new=50)
        srv.on_step.append(lambda s, step: clk.advance(0.004))
        srv.run()
        return _done(srv)

    assert run_both(scenario)["counters"]["expired"] == 1


def test_decode_fault_requeues_and_completes():
    def scenario(side):
        plan = side.FaultPlan(serve_decode_error_at=1)
        srv = side.ServingServer(plan.wrap_engine(eng2(side)),
                                 max_queue=8, max_retries=1,
                                 clock=side.ManualClock())
        for p in prompts_rng(2, [5, 9], seed=10):
            srv.submit(p, max_new=6)
        srv.run()
        return _done(srv, plan)

    got = run_both(scenario)
    assert got["fired"] == ["sdecode@1"]
    assert got["counters"]["retried"] == 2
    assert all(r.retries == 1 for r in got["results"].values())


def test_prefill_fault_requeues_only_that_request():
    def scenario(side):
        plan = side.FaultPlan(serve_prefill_error_at=0)
        srv = side.ServingServer(plan.wrap_engine(eng2(side)),
                                 max_queue=8, max_retries=1,
                                 clock=side.ManualClock())
        for p in prompts_rng(2, [5, 7], seed=11):
            srv.submit(p, max_new=4)
        srv.run()
        return _done(srv, plan)

    got = run_both(scenario)
    assert got["fired"] == ["sprefill@0"]
    assert [r.retries for _, r in sorted(got["results"].items())] == [1, 0]


def test_retry_budget_exhaustion_fails():
    def scenario(side):
        plan = side.FaultPlan(serve_error_first_n=10)
        srv = side.ServingServer(plan.wrap_engine(eng2(side)),
                                 max_queue=8, max_retries=2,
                                 clock=side.ManualClock())
        srv.submit(prompts_rng(1, [5], seed=12)[0], max_new=4)
        srv.run()
        return _done(srv, plan)

    got = run_both(scenario)
    (res,) = got["results"].values()
    assert res.outcome == "failed"
    assert "retry budget exhausted" in res.error


def test_page_alloc_fault_and_prefix_corruption():
    """The page-pool seams of wrap_page_pool (no JAX server test drives
    them): an admission that finds the pool 'exhausted' rides the
    requeue path, and a corrupted prefix-cache hit is rejected and
    recomputed."""
    def scenario(side):
        plan = side.FaultPlan(serve_page_alloc_error_at=1,
                              serve_prefix_corrupt_at=0)
        srv = side.ServingServer(
            plan.wrap_engine(ENGINE(side, "paged4", slots=2, max_len=32,
                                    page_size=4)),
            max_queue=8, max_retries=1,
                                 clock=side.ManualClock())
        pre = prompts_rng(1, [8], seed=13)[0]
        for tail in prompts_rng(3, [3], seed=14):
            srv.submit(list(pre) + list(tail), max_new=4)
        srv.run()
        return _done(srv, plan)

    got = run_both(scenario)
    assert sorted(got["fired"]) == ["pagealloc@1", "prefixcorrupt@0"]
    assert got["counters"]["prefix_rejected"] >= 1
