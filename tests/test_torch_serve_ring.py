"""The ring-cache convention and the sliding-window ring pools against
the JAX package: the rolling-window `generate`, `_cached_attention` with
a per-row slot vector (the sentinel slot drops its write),
`_ring_slot_valid`/`_band_valid`, and a DecodeEngine over an
`attn_window` config -- one-shot ring prefill, per-row ring decode,
retirement on eos or budget only -- bare and under ServingServer, float
and int8 KV."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.models import transformer as TT
from torch_serving import (JAX, TORCH, make_engine, models, prompts_rng,
                           run_both)

W = 6
ROLLING = [(kv, t0) for kv in ("compute", "int8") for t0 in (4, 9)]


def _rolling_prompt(t0):
    return np.random.RandomState(t0).randint(0, 61, (2, t0)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_rolling():
    """JAX's rolling-window generate() for each case (its scan compiles
    once per case, outside the cases)."""
    out = {}
    for kv, t0 in ROLLING:
        jcfg, _, jp, _ = models(kv, W)
        out[kv, t0] = np.asarray(JT.generate(
            jp, jcfg, jnp.asarray(_rolling_prompt(t0)), steps=11))
    return out


@pytest.mark.parametrize("kv", ["compute", "int8"])
@pytest.mark.parametrize("t0", [4, 9])
def test_rolling_generate_matches_jax(kv, t0, jax_rolling):
    """window 6 under prompts shorter and longer than it, 11 steps."""
    _, tcfg, _, tp = models(kv, W)
    prompt = _rolling_prompt(t0)
    want = jax_rolling[kv, t0]
    got = TT.generate(tp, tcfg, torch.from_numpy(prompt), 11).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[0, t0:].tolist())) > 2


def test_ring_slot_and_band_conventions_match_jax():
    pos = np.asarray([0, 3, 5, 6, 13, 40], np.int32)
    js, jv = JT._ring_slot_valid(jnp.asarray(pos), W)
    ts, tv = TT._ring_slot_valid(torch.from_numpy(pos), W)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for t in (0, 4, 11):
        s, v = TT._ring_slot_valid(t, W)
        js, jv = JT._ring_slot_valid(t, W)
        assert s == int(js)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        ar = np.arange(16)
        np.testing.assert_array_equal(
            TT._band_valid(torch.from_numpy(ar), t, W).numpy(),
            np.asarray(JT._band_valid(jnp.asarray(ar), t, W)))


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_cached_attention_with_a_slot_vector_matches_jax(kv):
    """Per-row write slots, one of them the out-of-range sentinel: its
    write is dropped, the others land at their own slots."""
    rs = np.random.RandomState(0)
    b, h, hkv, dh, total = 4, 4, 2, 8, W
    q = rs.standard_normal((b, 1, h, dh)).astype(np.float32)
    k = rs.standard_normal((b, 1, hkv, dh)).astype(np.float32)
    v = rs.standard_normal((b, 1, hkv, dh)).astype(np.float32)
    kb = rs.standard_normal((b, total, hkv, dh)).astype(np.float32)
    vb = rs.standard_normal((b, total, hkv, dh)).astype(np.float32)
    t = np.asarray([2, 0, W, 5], np.int32)          # row 2: the sentinel
    valid = rs.rand(b, 1, 1, total) > 0.3
    valid[:, ..., 0] = True
    jq = lambda x: JT._kv_quantize(jnp.asarray(x))
    tq = lambda x: TT.kv_quantize(torch.from_numpy(x))
    jk, jv_ = ((jq(kb), jq(vb)) if kv == "int8"
               else (jnp.asarray(kb), jnp.asarray(vb)))
    tk, tv = ((tq(kb), tq(vb)) if kv == "int8"
              else (torch.from_numpy(kb.copy()), torch.from_numpy(vb.copy())))
    jo, jk2, jv2 = JT._cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jk, jv_,
        jnp.asarray(t), jnp.asarray(valid))
    to, tk2, tv2 = TT._cached_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tk,
        tv, torch.from_numpy(t), torch.from_numpy(valid))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    pairs = ([(tk2[0], jk2[0]), (tk2[1], jk2[1]), (tv2[0], jv2[0]),
              (tv2[1], jv2[1])] if kv == "int8"
             else [(tk2, jk2), (tv2, jv2)])
    for a, c in pairs:
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(c).astype(np.float64),
                                   rtol=0, atol=1e-5)
    if kv == "compute":
        np.testing.assert_array_equal(tk2[2].numpy(), kb[2])   # dropped
        np.testing.assert_array_equal(tk2[0, 2].numpy(), k[0, 0])


def _ring_prompts():
    return prompts_rng(5, [3, 9, 5, 12, 7], seed=1)


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_ring_engine_serve_matches_jax(kv):
    """Prompts shorter and longer than the window, padded to one bucket;
    20 new tokens (over three windows); an eos id that some rows hit."""
    out = {}
    for side in (JAX, TORCH):
        eng = make_engine(side, slots=2, max_len=16, attn_window=W,
                          kv_cache_dtype=kv, eos_id=5)
        assert not eng.paged
        toks, lps = eng.serve(_ring_prompts(), max_new=20, buckets=(16,),
                              return_logprobs=True)
        out[side.name] = (toks, lps, eng.last_stats.steps)
    (jt, jl, js), (tt, tl, ts) = out["jax"], out["torch"]
    assert tt == jt and ts == js
    for a, c in zip(tl, jl):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-4)
    # past max_len: a ring row is bounded by eos and max_new only
    assert max(len(t) for t in tt) == 20


def test_ring_engine_admits_prompts_past_max_len():
    prompt = prompts_rng(1, [20], seed=2)[0]
    out = {}
    for side in (JAX, TORCH):
        eng = make_engine(side, slots=1, max_len=16, attn_window=W)
        out[side.name] = eng.serve([prompt], max_new=8)
        with pytest.raises(ValueError, match="paged engine"):
            eng.serve([prompt], max_new=2, speculative=True)
    assert out["torch"] == out["jax"]


def test_server_over_ring_engine_matches_jax():
    def scenario(side):
        clk = side.ManualClock()
        eng = make_engine(side, slots=2, max_len=16, attn_window=W)
        plan = side.FaultPlan(serve_decode_error_at=3)
        srv = side.ServingServer(plan.wrap_engine(eng), max_queue=8,
                                 clock=clk, buckets=(16,), max_retries=1)
        for i, p in enumerate(_ring_prompts()):
            srv.submit(p, max_new=12, deadline_ms=(30 if i == 3 else None))
        srv.on_step.append(lambda s, step: clk.advance(0.002))
        srv.run()
        srv.reconcile()
        return dict(results=dict(srv.results), counters=srv.counters(),
                    fired=list(plan.fired))

    got = run_both(scenario)
    outs = sorted(r.outcome for r in got["results"].values())
    assert "expired" in outs and outs.count("completed") == 4
