"""Disaggregated prefill/decode on the port against the JAX package: a
role="prefill" replica parks each finished prefill, its KV pages
migrate (pause_slot / export_slot_kv / import_slot_kv / resume_slot) to
a role="decode" replica, and the destination decodes on. The JAX tests
(tests/test_disagg.py) hold their router against generate(); here the
JAX router over JAX engines is the reference for the port's, with float
and int8 KV, inline payloads and a shared-memory data plane, and a
destination killed mid-import."""

import numpy as np
import pytest

from torch_serving import JAX, engine_cache, run_both, warm_engines

pytestmark = [pytest.mark.faults, pytest.mark.router]

ENGINE = engine_cache()
BUCKETS = (16,)


def engines(side, kv="compute"):
    return [ENGINE(side, f"d{i}_{kv}", slots=2, max_len=32, page_size=4,
                   prefill_chunk=8, kv_cache_dtype=kv) for i in range(3)]


@pytest.fixture(scope="module", autouse=True)
def warm():
    for kv in ("compute", "int8"):
        warm_engines(JAX, engines(JAX, kv), (11,), buckets=BUCKETS)


def make_fleet(side, clk, kv="compute", *,
               roles=("prefill", "decode", "decode"), wrap=None,
               data_plane=None, **router_kw):
    servers = []
    for i, (eng, role) in enumerate(zip(engines(side, kv), roles)):
        if wrap and wrap.get(i) is not None:
            eng = wrap[i](eng)
        servers.append(side.ServingServer(
            eng, role=role, max_queue=16, clock=clk, buckets=BUCKETS,
            max_retries=2, data_plane=data_plane))
    return side.ServingRouter(servers, clock=clk, probe_interval_s=1e9,
                              **router_kw)


def prompts_for(n, seed, lo=9, hi=14):
    r = np.random.RandomState(seed)
    return [r.randint(1, 60, (int(r.randint(lo, hi)),)).astype(np.int32)
            for _ in range(n)]


def _done(router, *plans, **extra):
    router.reconcile()
    return dict(results=dict(router.results), counters=router.counters(),
                per_replica=router.per_replica(),
                fired=[list(p.fired) for p in plans], **extra)


def test_prefill_role_parks_pins_and_acks():
    def scenario(side):
        srv = side.ServingServer(engines(side)[0], role="prefill",
                                 buckets=BUCKETS, clock=side.ManualClock())
        rid = srv.submit(np.arange(1, 12, dtype=np.int32), max_new=4)
        srv.run()
        parked = srv.ready_handoffs()
        pool = srv._active_pool
        pool.reconcile()
        payload = srv.export_request(rid)
        seed = payload["seed"]
        srv.handoff_complete(rid)
        srv.reconcile()
        return dict(parked=parked, pins=pool.exports_outstanding,
                    n_pages=payload["n_pages"],
                    geometry=payload["geometry"],
                    seed=(seed.pos, seed.last_tok, seed.temp, seed.top_k,
                          seed.top_p),
                    counters=srv.counters())

    got = run_both(scenario)
    assert got["parked"] == [0] and got["pins"] == 0
    assert got["counters"]["migrated_out"] == 1


def test_cancel_handoff_decodes_locally():
    def scenario(side):
        srv = side.ServingServer(engines(side)[0], role="prefill",
                                 buckets=BUCKETS, clock=side.ManualClock())
        rid = srv.submit(np.arange(2, 13, dtype=np.int32), max_new=4)
        srv.run()
        srv.cancel_handoff(rid)
        srv.run()
        srv.reconcile()
        return dict(results=dict(srv.results), counters=srv.counters())

    got = run_both(scenario)
    assert got["counters"]["handoffs_cancelled"] == 1


def test_deadline_expires_while_parked():
    def scenario(side):
        clk = side.ManualClock()
        srv = side.ServingServer(engines(side)[0], role="prefill",
                                 buckets=BUCKETS, clock=clk)
        srv.submit(np.arange(1, 10, dtype=np.int32), max_new=4,
                   deadline_ms=500)
        srv.run()
        clk.advance(1.0)
        srv.step()
        srv.reconcile()
        return dict(results=dict(srv.results), counters=srv.counters(),
                    parked=srv.ready_handoffs())

    got = run_both(scenario)
    assert got["parked"] == [] and got["counters"]["expired"] == 1


def test_import_gates():
    def scenario(side):
        eng = engines(side)
        src = side.ServingServer(eng[0], role="prefill", buckets=BUCKETS,
                                 clock=side.ManualClock())
        rid = src.submit(np.arange(3, 14, dtype=np.int32), max_new=4)
        src.run()
        payload = src.export_request(rid)
        dst = side.ServingServer(eng[1], role="decode", buckets=BUCKETS,
                                 clock=side.ManualClock())
        dst.drain(reason="test")
        with pytest.raises(side.MigrationRefusedError):
            dst.import_request(payload)
        bad = dict(payload, geometry=dict(payload["geometry"],
                                          page_size=999))
        dst2 = side.ServingServer(eng[2], role="decode", buckets=BUCKETS,
                                  clock=side.ManualClock())
        with pytest.raises(ValueError, match="geometry mismatch"):
            dst2.import_request(bad)
        pins = src._active_pool.exports_outstanding
        src.cancel_handoff(rid)
        src.run()
        src.reconcile()
        return dict(results=dict(src.results), pins=pins)

    assert run_both(scenario)["pins"] == 1


@pytest.mark.parametrize("plane", ["inline", "shm"])
@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_parity_through_migration(kv, plane):
    """Every request crosses from the prefill tier by export/import and
    decodes on the decode tier; the repeat prefix then routes straight
    to the decode replica whose cache the migration seeded."""
    def scenario(side):
        arena = (side.ShmArena(seg_size=64 * 1024, n_segs=32)
                 if plane == "shm" else None)
        try:
            router = make_fleet(side, side.ManualClock(), kv,
                                data_plane=arena)
            for p in prompts_for(3, seed=7):
                router.submit(p, max_new=5)
            router.run()
            router.reconcile()
            wave1 = router.counters()
            prefix = np.asarray([5, 9, 2, 44, 17, 3, 28, 51], np.int32)
            for tail in ([7, 11, 30], [19, 4, 55]):
                router.submit(np.concatenate([prefix, tail]), max_new=5)
                router.run()
            return _done(router, wave1=wave1,
                         scattered=(arena.scatters if arena else None))
        finally:
            if arena is not None:
                arena.close(destroy=True)

    got = run_both(scenario, router=True)
    c = got["wave1"]
    assert c["migrations"] == c["fleet_migrated_in"] == 3
    assert c["fleet_data_plane_fallbacks"] == 0
    assert all(r.replica in (1, 2) for r in got["results"].values())
    if plane == "shm":
        assert got["scattered"] >= 3


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_destination_death_mid_import_retries(kv):
    def scenario(side):
        clk = side.ManualClock()
        plan = side.FaultPlan(router_kill_import_at=0)
        router = make_fleet(
            side, clk, kv,
            wrap={1: lambda e: plan.wrap_replica_engine(e, clock=clk)})
        for p in prompts_for(2, seed=9):
            router.submit(p, max_new=6)
        router.run()
        src = router.replicas[0].server
        return _done(router, plan,
                     pins=src._active_pool.exports_outstanding)

    got = run_both(scenario, router=True)
    c = got["counters"]
    assert got["fired"] == [["importkill@0"]] and got["pins"] == 0
    assert c["replicas_lost"] == 1 and c["migration_retargets"] == 1
    assert all(r.replica == 2 for r in got["results"].values())


def test_destination_death_with_no_survivor_cancels():
    def scenario(side):
        clk = side.ManualClock()
        plan = side.FaultPlan(router_kill_import_at=0)
        router = make_fleet(
            side, clk, roles=("prefill", "decode"),
            wrap={1: lambda e: plan.wrap_replica_engine(e, clock=clk)})
        router.submit(np.arange(1, 13, dtype=np.int32), max_new=6)
        router.run()
        return _done(router, plan)

    got = run_both(scenario, router=True)
    assert got["counters"]["migration_failed"] == 1
    assert [r.replica for r in got["results"].values()] == [0]


def test_source_death_while_parked_resubmits_exactly_once():
    def scenario(side):
        clk = side.ManualClock()
        plan = side.FaultPlan()
        router = make_fleet(side, clk)
        src = router.replicas[0]
        router.submit(np.arange(3, 15, dtype=np.int32), max_new=6)
        src.server.step()
        while src.server._prefilling:
            src.server.step()
        parked = src.server.ready_handoffs()
        src.server.engine = plan.wrap_replica_engine(src.server.engine,
                                                     clock=clk)
        src.server.engine.dead = True
        src.server._backend = src.server.engine
        router.run()
        return _done(router, plan, parked=parked)

    got = run_both(scenario, router=True)
    assert got["parked"] and got["counters"]["redistributed"] == 1
