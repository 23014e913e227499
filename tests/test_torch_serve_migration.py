"""The port's DecodeEngine surface that the server and router read, held
against the JAX engine: the pool-wide `select_fn`, a custom scheduler
`policy`, the prefix-cache knobs, `ping`/`kv_geometry`, and KV-block
migration (pause_slot / export_slot_kv / import_slot_kv / resume_slot)
between two engines of each package, float and int8 arenas."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_serving import JAX, TORCH, make_engine, prompts_rng

PAGE = 4


def _second_best(side):
    """A select_fn that ignores its rng: the same tokens on both sides.
    The port's records what it was handed."""
    if side is JAX:
        return lambda lg, key: jnp.argsort(lg, axis=-1)[:, -2]
    seen = []

    def fn(lg, gen):
        seen.append(gen)
        return torch.argsort(lg, dim=-1)[:, -2]

    fn.seen = seen
    return fn


def test_select_fn_matches_jax_and_gets_slot_generators():
    ps = prompts_rng(4, [5, 9, 3, 7], seed=1)
    out, fns = {}, {}
    for side in (JAX, TORCH):
        fns[side.name] = _second_best(side)
        eng = make_engine(side, slots=2, max_len=32, page_size=PAGE,
                          select_fn=fns[side.name])
        out[side.name] = eng.serve(ps, max_new=6, buckets=(16,))
        with pytest.raises(ValueError, match="mutually exclusive"):
            eng.serve(ps[:1], max_new=2, sampling=[{"temperature": 0.5}])
        with pytest.raises(ValueError, match="select_fn"):
            eng.serve(ps[:1], max_new=2, speculative=True)
    assert out["torch"] == out["jax"]
    seen = fns["torch"].seen
    assert seen and all(isinstance(g, torch.Generator) for g in seen)


class _Lifo:
    """Newest-first admission: changes which requests share the pool
    (and so the prefix hits and step count) without changing tokens."""

    def __init__(self, base):
        self.__class__ = type("Lifo", (base,),
                              {"next_index": lambda s, q: len(q) - 1})
        base.__init__(self)


@pytest.mark.parametrize("knobs", [
    dict(), dict(prefix_cache=False), dict(prefix_cache_blocks=1),
    dict(policy="lifo")])
def test_policy_and_prefix_cache_knobs_match_jax(knobs):
    pre = prompts_rng(1, [8], seed=2)[0]
    ps = [np.concatenate([pre, t]) for t in prompts_rng(4, [3, 5], seed=3)]
    ps += prompts_rng(2, [6], seed=4)
    res = {}
    for side in (JAX, TORCH):
        kw = dict(knobs)
        if kw.get("policy") == "lifo":
            kw["policy"] = _Lifo(side.SchedulerPolicy)
        eng = make_engine(side, slots=2, max_len=32, page_size=PAGE, **kw)
        toks = eng.serve(ps, max_new=5, buckets=(16,))
        s = eng.last_stats
        res[side.name] = (toks, s.steps, s.prefix_hits, s.prefix_misses,
                          s.peak_pages_in_use)
    assert res["torch"] == res["jax"]
    if knobs.get("prefix_cache") is False:
        assert res["torch"][2] == 0
    elif not knobs:
        assert res["torch"][2] > 0


def test_ping_and_kv_geometry_match_jax():
    geo = {}
    for side in (JAX, TORCH):
        eng = make_engine(side, slots=2, max_len=30, page_size=PAGE,
                          kv_cache_dtype="int8")
        assert eng.ping() is None and eng.paged
        geo[side.name] = eng.kv_geometry()
    assert geo["torch"] == geo["jax"]
    assert geo["torch"]["max_pages_per_slot"] == 8


def _migrate(side, kv, prompt, *, steps_before=2, steps_after=6,
             sampling=None):
    """Prefill + decode on engine A, pause, export, import into engine B
    (whose cache already holds the prompt's first two blocks), resume
    and decode on B. Returns (seed, exported kv, start_block, tokens
    A emitted, tokens B emitted)."""
    a = make_engine(side, slots=2, max_len=32, page_size=PAGE,
                    kv_cache_dtype=kv)
    b = make_engine(side, slots=2, max_len=32, page_size=PAGE,
                    kv_cache_dtype=kv)
    sa = a.init_state()
    sa = a.prefill(sa, 1, prompt, sampling=sampling)
    emitted_a = []
    for _ in range(steps_before):
        sa, tok, _, _, _ = a.decode_step(sa)
        emitted_a.append(int(np.asarray(tok)[1]))
        sa = a.ensure_decode_page(sa, 1)
    sa, seed = a.pause_slot(sa, 1)
    _, pages = a.pool.export_blocks(1)
    kv_out = a.export_slot_kv(sa, pages)
    sb = b.init_state()
    # seed B's prefix cache with the prompt's first two blocks
    sb = b.prefill(sb, 0, prompt[:9])
    sb = b.release_slot(sb, 0)
    true_len = seed.pos
    hist = np.concatenate([prompt, emitted_a]).astype(np.int32)[:true_len]
    pages_b, start = b.pool.import_blocks(0, hist, true_len)
    sb = b.import_slot_kv(sb, 0, pages_b, start, kv_out)
    sb = b.resume_slot(sb, 0, seed)
    emitted_b = []
    for _ in range(steps_after):
        sb, tok, _, _, _ = b.decode_step(sb)
        emitted_b.append(int(np.asarray(tok)[0]))
        sb = b.ensure_decode_page(sb, 0)
    return seed, kv_out, start, emitted_a, emitted_b


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_migration_matches_jax(kv):
    prompt = prompts_rng(1, [11], seed=5)[0]
    jseed, jkv, jstart, ja, jb = _migrate(JAX, kv, prompt)
    tseed, tkv, tstart, ta, tb = _migrate(TORCH, kv, prompt)
    assert (ta, tb, tstart) == (ja, jb, jstart) and tstart == 2
    assert (tseed.pos, tseed.last_tok, tseed.temp, tseed.top_k,
            tseed.top_p) == (jseed.pos, jseed.last_tok, jseed.temp,
                             jseed.top_k, jseed.top_p)
    assert abs(tseed.last_lp - jseed.last_lp) < 1e-4
    assert tseed.rng_key_data.size == 0          # a greedy slot
    assert len(tkv) == len(jkv) == 2
    ties = 0
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        for t, j in ((tk, jk), (tv, jv)):
            if kv == "compute":
                np.testing.assert_allclose(t, _np(j), rtol=0, atol=1e-5)
                continue
            (td, ts), (jd, js) = t, (_np(j[0]), _np(j[1]))
            assert td.dtype == np.int8 and td.shape == jd.shape
            np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-12)
            off = td.astype(np.int32) != jd.astype(np.int32)
            # int8 data is exact but where the two packages' f32
            # rounding lands on the other side of .5: off by one code,
            # the dequantized values within one quantization step
            assert np.abs(td.astype(np.int32) - jd)[off].max(initial=0) <= 1
            ties += int(off.sum())
            np.testing.assert_allclose(
                td * ts[..., None], jd * js[..., None], rtol=0,
                atol=float(js.max()) + 1e-6)
    if kv == "int8":
        assert ties <= 0.001 * sum(np.asarray(t[0]).size
                                   for pair in tkv for t in pair)


def test_sampled_request_keeps_its_stream_across_migration():
    """A sampled slot's generator state rides DecodeSeed.rng_key_data:
    the migrated request draws what it would have drawn unmoved."""
    prompt = prompts_rng(1, [11], seed=6)[0]
    samp = {"temperature": 0.9, "seed": 7}
    seed, _, _, a_toks, b_toks = _migrate(TORCH, "compute", prompt,
                                          sampling=samp)
    assert seed.rng_key_data.size > 0
    eng = make_engine(TORCH, slots=2, max_len=32, page_size=PAGE)
    st = eng.prefill(eng.init_state(), 1, prompt, sampling=samp)
    unmoved = []
    for _ in range(len(a_toks) + len(b_toks)):
        st, tok, _, _, _ = eng.decode_step(st)
        unmoved.append(int(tok[1]))
        st = eng.ensure_decode_page(st, 1)
    assert a_toks + b_toks == unmoved
    assert len(set(unmoved)) > 1


def test_pause_then_resume_in_place_is_invisible():
    prompt = prompts_rng(1, [7], seed=8)[0]
    eng = make_engine(TORCH, slots=1, max_len=32, page_size=PAGE)
    ref = eng.serve([prompt], max_new=6)[0]
    st = eng.prefill(eng.init_state(), 0, prompt)
    out = []
    for i in range(6):
        if i == 3:
            st, seed = eng.pause_slot(st, 0)
            st, tok, _, was, _ = eng.decode_step(st)
            assert not bool(was[0])            # parked: decodes nothing
            st = eng.resume_slot(st, 0, seed)
        st, tok, _, _, _ = eng.decode_step(st)
        out.append(int(tok[0]))
        st = eng.ensure_decode_page(st, 0)
    assert out == ref


def test_artifact_entry_points_name_their_roadmap_item(tmp_path):
    """The artifact entry points are ported: a server handed a bundle
    path that holds none keeps the eager path, the failure counted once
    with its flight event, as the JAX server does."""
    from paddle_tpu_torch.obs.flight import FlightRecorder

    eng = make_engine(TORCH, slots=1, max_len=16)
    flight = FlightRecorder()
    srv = TORCH.ServingServer(eng, artifact_path=str(tmp_path / "none.tar"),
                              flight=flight)
    assert (eng.artifact_loads, eng.artifact_fallbacks) == (0, 1)
    evs = [e for e in flight.events() if e["kind"] == "artifact"]
    assert len(evs) == 1 and evs[0]["member"] == "load"
    assert "FileNotFoundError" in evs[0]["error"]
    assert srv.counters()["artifact_fallbacks"] == 1
    rid = srv.submit(np.arange(3), max_new=2)
    assert srv.run()[rid].outcome == "completed"


def test_unported_fault_seams_fail_by_name():
    """Every seam of the JAX plan is ported now: the fleet and cluster
    fields come with their wraps (exercised on real processes in
    tests/test_torch_fleet.py and test_torch_agent.py), and
    build_chaos_replica builds a server (test_torch_fleet.py)."""
    from paddle_tpu_torch.testing.faults import build_chaos_replica

    plan = TORCH.FaultPlan(fleet_sigkill_at=1, fleet_sigkill_replica=2,
                           cluster_sigkill_at=3, cluster_sigkill_host="h")
    assert (plan.fleet_sigkill_at, plan.fleet_sigkill_replica,
            plan.cluster_sigkill_at, plan.cluster_sigkill_host) == (
        1, 2, 3, "h")
    assert callable(plan.wrap_fleet) and callable(plan.wrap_cluster)
    # the pserver, master and online faults came with the pserver tier
    plan = TORCH.FaultPlan(pserver_kill_push_at=1, online_kill_step_at=2,
                           master_drop_at=3)
    assert (plan.pserver_kill_push_at, plan.online_kill_step_at,
            plan.master_drop_at) == (1, 2, 3)
    # the gang faults came with the elastic layer (wrap_gang)
    plan = TORCH.FaultPlan(gang_kill_step_at=1, gang_wedge_step_at=2)
    assert (plan.gang_kill_rank, plan.gang_wedge_rank) == (1, 1)
    # the builder's own keyword contract: a config script is required
    with pytest.raises(TypeError, match="config"):
        build_chaos_replica()
