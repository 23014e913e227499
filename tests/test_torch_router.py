"""The port's ServingRouter held against the JAX package's, case by case
of tests/test_router.py: prefix-affinity routing, a replica killed
mid-burst, health probes and their breaker, the slow replica, retire.
Each case builds a three-replica fleet on each package (the same
weights, submissions, ManualClock and FaultPlan) and the two runs must
give equal results (outcome, tokens, replica, redistributions, error
text; logprobs within 1e-4), fleet counters and fired faults."""

import numpy as np
import pytest

from torch_serving import (JAX, TORCH, engine_cache, family_prompts,
                           run_both, warm_engines)

pytestmark = [pytest.mark.faults, pytest.mark.router]

ENGINE = engine_cache()


def engines(side):
    return [ENGINE(side, f"r{i}", slots=2, max_len=32, page_size=4)
            for i in range(3)]


@pytest.fixture(scope="module", autouse=True)
def warm():
    warm_engines(JAX, engines(JAX), (9, 11))
    warm_engines(JAX, engines(JAX), (11,), buckets=(16,))


def make_fleet(side, clk, *, wrap=None, max_queue=16, max_retries=2,
               probe_interval_s=1.0, policy=None, buckets=None,
               **router_kw):
    servers = []
    for i, eng in enumerate(engines(side)):
        if wrap and wrap.get(i) is not None:
            eng = wrap[i](eng)
        servers.append(side.ServingServer(eng, max_queue=max_queue,
                                          clock=clk, buckets=buckets,
                                          max_retries=max_retries))
    return side.ServingRouter(servers, clock=clk,
                              probe_interval_s=probe_interval_s,
                              policy=policy, **router_kw)


def routed_to(router, rr_id):
    for rep in router.replicas:
        if rr_id in rep.pending.values():
            return rep.rid
    return None


def _done(router, *plans, **extra):
    router.reconcile()
    return dict(results=dict(router.results), counters=router.counters(),
                per_replica=router.per_replica(),
                fired=[list(p.fired) for p in plans], **extra)


def test_affinity_groups_prefix_families():
    def scenario(side):
        router = make_fleet(side, side.ManualClock())
        for p in family_prompts(6, seed=1):
            router.submit(p, max_new=4)
        router.run()
        return _done(router)

    got = run_both(scenario, router=True)
    assert got["counters"]["affinity_hits"] >= 3
    by_family = {}
    for rid, res in got["results"].items():
        by_family.setdefault(rid % 3, set()).add(res.replica)
    assert all(len(reps) == 1 for reps in by_family.values())


def test_affinity_key_matches_pool_derivation():
    p = np.arange(11, dtype=np.int32)
    chains = []
    for side in (JAX, TORCH):
        router = make_fleet(side, side.ManualClock())
        chain = router._chain(p)
        assert chain == side.chain_keys(p, 11, 4)
        chains.append(chain)
    assert chains[0] == chains[1]
    assert chains[1][1] == (chains[1][0], (4, 5, 6, 7))


def test_spill_to_least_loaded_on_miss():
    def scenario(side):
        router = make_fleet(side, side.ManualClock())
        r = np.random.RandomState(7)
        used = []
        for _ in range(6):
            rid = router.submit(r.randint(0, 61, (9,)).astype(np.int32),
                                max_new=2)
            used.append(routed_to(router, rid))
        router.run()
        return _done(router, used=used)

    assert set(run_both(scenario, router=True)["used"]) == {0, 1, 2}


def test_affinity_target_full_spills_not_sheds():
    def scenario(side):
        router = make_fleet(side, side.ManualClock(), max_queue=2)
        ids = [router.submit(p, max_new=2)
               for p in family_prompts(5, seed=61, n_families=1)]
        spread = len({routed_to(router, rid) for rid in ids})
        router.run()
        return _done(router, spread=spread)

    got = run_both(scenario, router=True)
    assert got["spread"] >= 2 and got["counters"]["shed"] == 0


def test_random_policy_scatters():
    def scenario(side):
        router = make_fleet(side, side.ManualClock(),
                            policy=side.RandomRoutingPolicy(seed=3))
        for p in family_prompts(9, seed=1, n_families=1):
            router.submit(p, max_new=2)
        router.run()
        return _done(router)

    got = run_both(scenario, router=True)
    assert len({r.replica for r in got["results"].values()}) >= 2


def test_kill_midburst_exactly_once_and_hit_rate_recovers():
    """Warm wave, then a burst with replica 0 killed at its 5th decode
    step (and garbage), then a recovery wave."""
    def scenario(side):
        clk = side.ManualClock()
        plan = side.FaultPlan()
        router = make_fleet(
            side, clk, buckets=(16,),
            wrap={0: lambda e: plan.wrap_replica_engine(e, clock=clk)})
        for p in family_prompts(6, seed=11, prefix_seed=99):
            router.submit(p, max_new=4)
        router.run()
        router.reconcile()
        pre_rate = router.prefix_hit_rate()
        plan.router_kill_decode_at = plan._router_decode_counter + 4
        for p in family_prompts(9, seed=12, prefix_seed=99):
            router.submit(p, max_new=4)
        errors = []
        for g in side.garbage_prompts(61, 16).values():
            with pytest.raises(ValueError) as e:
                router.submit(g, max_new=2)
            errors.append(str(e.value))
        router.run()
        router.reconcile()
        burst = router.counters()
        for p in family_prompts(6, seed=13, prefix_seed=99):
            router.submit(p, max_new=4)
        router.run()
        return _done(router, plan, pre_rate=pre_rate, burst=burst,
                     errors=errors)

    got = run_both(scenario, router=True)
    (fired,) = got["fired"]
    assert len(fired) == 1 and fired[0].startswith("replicakill@")
    c = got["burst"]
    assert c["replicas_lost"] == 1 and c["redistributed"] >= 1
    assert c["failed"] == 6


def test_kill_preserves_retry_budgets():
    def scenario(side):
        clk = side.ManualClock()
        plan = side.FaultPlan(router_kill_decode_at=0)
        router = make_fleet(
            side, clk, max_retries=2,
            wrap={0: lambda e: plan.wrap_replica_engine(e, clock=clk)})
        for p in family_prompts(4, seed=21, n_families=1):
            router.submit(p, max_new=3)
        router.run()
        return _done(router, plan)

    got = run_both(scenario, router=True)
    assert got["counters"]["redistributed"] >= 1
    assert all(r.retries == 0 for r in got["results"].values())


def test_all_replicas_dead_fails_closed():
    def scenario(side):
        clk = side.ManualClock()
        plans = [side.FaultPlan(router_kill_decode_at=0)
                 for _ in range(3)]
        router = make_fleet(
            side, clk,
            wrap={i: (lambda e, p=plans[i]:
                      p.wrap_replica_engine(e, clock=clk))
                  for i in range(3)})
        ps = family_prompts(3, seed=22)
        for p in ps:
            router.submit(p, max_new=3)
        router.run()
        router.reconcile()
        with pytest.raises(side.RouterQueueFullError, match="no routable"):
            router.submit(ps[0], max_new=2)
        return _done(router, *plans)

    got = run_both(scenario, router=True)
    assert got["counters"]["replicas_alive"] == 0


def test_probe_blackhole_opens_breaker_and_recovers():
    def scenario(side):
        clk = side.ManualClock()
        plan = side.FaultPlan(router_probe_drop_first_n=2)
        router = make_fleet(side, clk, probe_interval_s=1.0,
                            failure_threshold=2, cooldown_s=5.0)
        plan.wrap_probe(router.replicas[0])
        router.probe_all()
        clk.advance(1.5)
        router.probe_all()
        opened = (router.replicas[0].breaker.state,
                  router.replicas[0].routable())
        for p in family_prompts(4, seed=31):
            router.submit(p, max_new=3)
        router.run()
        router.reconcile()
        clk.advance(6.0)
        router.probe_all()
        return _done(router, plan, opened=opened,
                     closed=router.replicas[0].breaker.state)

    got = run_both(scenario, router=True)
    assert got["opened"] == ("open", False) and got["closed"] == "closed"
    assert all(r.replica != 0 for r in got["results"].values())


def test_failing_half_open_probe_reopens_breaker():
    def scenario(side):
        clk = side.ManualClock()
        plan = side.FaultPlan(router_probe_drop_first_n=3)
        router = make_fleet(side, clk, probe_interval_s=1.0,
                            failure_threshold=2, cooldown_s=5.0)
        rep = router.replicas[0]
        plan.wrap_probe(rep)
        states = []
        for dt in (0.0, 1.5, 6.0, 1.5, 6.0):
            clk.advance(dt)
            router.probe_all()
            states.append((rep.breaker.state, rep.breaker.trips,
                           plan._router_probe_counter))
        return _done(router, plan, states=states)

    got = run_both(scenario, router=True)
    assert got["states"][-1][0] == "closed"


def test_probe_detects_dead_replica_with_queued_work():
    def scenario(side):
        clk = side.ManualClock()
        plan = side.FaultPlan()
        box = {}

        def wrap1(e):
            box["w"] = plan.wrap_replica_engine(e, clock=clk)
            return box["w"]

        router = make_fleet(side, clk, wrap={1: wrap1})
        ids = [router.submit(p, max_new=3)
               for p in family_prompts(6, seed=32)]
        victims = [rid for rid in ids if routed_to(router, rid) == 1]
        box["w"].dead = True
        router.run()
        return _done(router, plan, victims=victims)

    got = run_both(scenario, router=True)
    assert got["victims"] and got["counters"]["replicas_lost"] == 1


def test_slow_replica_skew_is_contained():
    def scenario(side):
        clk = side.ManualClock()
        plan = side.FaultPlan(router_slow_decode_s=0.04)
        router = make_fleet(
            side, clk,
            wrap={0: lambda e: plan.wrap_replica_engine(e, clock=clk)})
        for p in family_prompts(2, seed=41, n_families=1):
            router.submit(p, max_new=20, deadline_ms=100)
        for p in family_prompts(2, seed=42, n_families=1):
            router.submit(p, max_new=6, deadline_ms=2000)
        router.run()
        return _done(router, plan)

    got = run_both(scenario, router=True)
    outs = [r.outcome for _, r in sorted(got["results"].items())]
    assert outs == ["expired", "expired", "completed", "completed"]


def test_retire_redistributes_queue_zero_recompute():
    def scenario(side):
        router = make_fleet(side, side.ManualClock())
        for p in family_prompts(8, seed=51, n_families=2):
            router.submit(p, max_new=4)
        target = next(rep for rep in router.replicas if rep.server.queue)
        router.retire_replica(target.rid, reason="maintenance")
        router.run()
        router.reconcile()
        for rep in router.replicas:
            router.retire_replica(rep.rid)
        with pytest.raises(side.RouterQueueFullError, match="no routable"):
            router.submit(family_prompts(1, seed=51)[0], max_new=2)
        return _done(router, target=target.rid)

    got = run_both(scenario, router=True)
    assert all(r.replica != got["target"] for r in got["results"].values())
