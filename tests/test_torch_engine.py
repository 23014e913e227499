"""The port's paged DecodeEngine held against the live JAX DecodeEngine:
the same weights and prompts must give exactly the same greedy tokens,
with prefix-cache hits, chunked prefill and an oversubscribed page pool;
per-token log-probabilities agree within 1e-4 (float32 logits of unit
scale through a few layers, summed in another order)."""

import functools

import numpy as np
import pytest
import torch

from paddle_tpu.serve.engine import DecodeEngine as JEngine
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.serve.engine import DecodeEngine
from torch_parity import make_models, to_torch

CFG = dict(vocab=96, dim=32, n_layers=2, n_heads=4)
PAGE = 4


class _Models(tuple):
    """make_models' tuple, hashable by identity (the engine cache key)."""

    __hash__ = object.__hash__
    __eq__ = object.__eq__


@pytest.fixture(scope="module")
def models():
    return _Models(make_models(seed=0, **CFG))


def _prompts(seed, n=5, shared=8):
    """Half the prompts share a `shared`-token prefix (prefix hits)."""
    rs = np.random.RandomState(seed)
    pre = rs.randint(0, CFG["vocab"], shared)
    out = []
    for i in range(n):
        tail = rs.randint(0, CFG["vocab"], 2 + 2 * i)
        out.append(np.concatenate([pre, tail]).astype(np.int32) if i % 2 == 0
                   else rs.randint(0, CFG["vocab"], 5 + i).astype(np.int32))
    return out


@functools.lru_cache(maxsize=None)
def _jax_engine(models, geometry):
    """One JAX engine per pool geometry: serve() starts from a fresh
    pool each call, and reusing the engine reuses its compiled bodies."""
    jcfg, _, jp, _ = models
    return JEngine(jp, jcfg, **dict(geometry))


def _both(models, prompts, *, max_new, engine_kw, serve_kw=None):
    """Serve on both engines. Prompts are padded to one bucket length
    by default, which keeps the JAX engine to two prefill compiles (a
    from-zero chunk and a prefix-hit chunk)."""
    _, tcfg, _, tp = models
    serve_kw = dict(buckets=(24,)) if serve_kw is None else serve_kw
    j_eng = _jax_engine(models, tuple(sorted(engine_kw.items())))
    t_eng = DecodeEngine(tp, tcfg, device="cpu", **engine_kw)
    ref = j_eng.serve(prompts, max_new=max_new, **serve_kw)
    got = t_eng.serve(prompts, max_new=max_new, **serve_kw)
    return ref, got, j_eng, t_eng


def test_serve_matches_jax_with_prefix_hits(models):
    prompts = _prompts(0)
    ref, got, j_eng, t_eng = _both(
        models, prompts, max_new=7,
        engine_kw=dict(slots=2, max_len=40, page_size=PAGE))
    assert got == ref
    assert t_eng.last_stats.prefix_hits == j_eng.last_stats.prefix_hits > 0
    assert t_eng.last_stats.steps == j_eng.last_stats.steps
    assert len({t for r in got for t in r}) > 3          # tokens vary


# chunked prefill and the oversubscribed pool share one geometry, so the
# JAX engine compiles its bodies once for both tests
TIGHT = dict(slots=3, max_len=40, page_size=PAGE, num_pages=12,
             prefill_chunk=8)


def test_serve_matches_jax_chunked_prefill(models):
    ref, got, j_eng, t_eng = _both(models, _prompts(1), max_new=6,
                                   engine_kw=TIGHT)
    assert got == ref
    assert (t_eng.last_stats.prefill_chunks
            == j_eng.last_stats.prefill_chunks)


def test_serve_matches_jax_oversubscribed_pool(models):
    # 3 slots x 10 pages would be the dense capacity; 12 pages force
    # page-exhaustion preemption mid-decode
    ref, got, j_eng, t_eng = _both(models, _prompts(2, n=6), max_new=10,
                                   engine_kw=TIGHT)
    assert got == ref
    assert t_eng.last_stats.retried == j_eng.last_stats.retried > 0


def test_serve_logprobs_and_buckets_match_jax(models):
    ref, got, _, _ = _both(
        models, _prompts(3, n=4), max_new=5,
        engine_kw=dict(slots=2, max_len=40, page_size=PAGE),
        serve_kw=dict(return_logprobs=True, buckets=(16, 32)))
    assert got[0] == ref[0]
    np.testing.assert_allclose(np.concatenate(got[1]),
                               np.concatenate(ref[1]), atol=1e-4, rtol=0)


def test_serve_eos_matches_jax(models):
    prompts = _prompts(4, n=3)
    first = DecodeEngine(models[3], models[1], slots=2, max_len=40,
                         page_size=PAGE, device="cpu").serve(prompts,
                                                             max_new=6)
    eos = first[0][2]
    ref, got, _, _ = _both(
        models, prompts, max_new=6,
        engine_kw=dict(slots=2, max_len=40, page_size=PAGE, eos_id=eos))
    assert got == ref
    assert got[0][-1] == eos and len(got[0]) == 3


def test_engine_matches_generate(models):
    _, tcfg, _, tp = models
    prompts = _prompts(5, n=3)
    got = DecodeEngine(tp, tcfg, slots=2, max_len=40, page_size=PAGE,
                       device="cpu").serve(prompts, max_new=8)
    for p, toks in zip(prompts, got):
        ref = TT.generate(tp, tcfg, to_torch(p)[None], 8)[0, len(p):]
        assert toks == ref.tolist()


def test_sampled_requests_are_seed_deterministic(models):
    _, tcfg, _, tp = models
    prompts = _prompts(6, n=3)
    samp = [{"temperature": 1.0, "top_k": 20, "seed": 7}, {},
            {"temperature": 0.8, "top_p": 0.9, "seed": 3}]
    mk = lambda: DecodeEngine(tp, tcfg, slots=2, max_len=40, page_size=PAGE,
                              device="cpu")
    a = mk().serve(prompts, max_new=6, sampling=samp)
    b = mk().serve(prompts, max_new=6, sampling=samp)
    greedy = mk().serve(prompts, max_new=6)
    assert a == b
    assert a[1] == greedy[1]        # the greedy co-tenant is unperturbed


def test_unported_paths_raise(models):
    """Every serving path of the engine is ported: ring pools, migration,
    int8 KV pools and speculative rounds run (their parity:
    tests/test_torch_serve_*), and serving artifacts bind to paged
    engines (tests/test_torch_serve_artifact.py); a ring engine refuses
    the artifact surface by name, as the JAX engine does."""
    import dataclasses

    _, tcfg, _, tp = models
    ring = DecodeEngine(tp, dataclasses.replace(tcfg, attn_window=4),
                        slots=1, max_len=16, device="cpu")
    assert not ring.paged
    assert len(ring.serve([np.arange(3)], max_new=20)[0]) == 20
    with pytest.raises(ValueError, match="paged engines only"):
        ring.artifact_manifest()
    with pytest.raises(ValueError, match="paged engines only"):
        ring.state_spec()
    eng8 = DecodeEngine(tp, dataclasses.replace(tcfg, kv_cache_dtype="int8"),
                        slots=1, max_len=16, page_size=PAGE, device="cpu")
    assert len(eng8.serve([np.arange(3)], max_new=4)[0]) == 4
    assert eng8.init_state().caches[0][0][0].dtype == torch.int8
    eng = DecodeEngine(tp, tcfg, slots=1, max_len=16, device="cpu")
    out = eng.serve([np.arange(3)], max_new=4, speculative=True)
    assert len(out[0]) == 4 and eng.last_stats.spec_rounds > 0
    st = eng.prefill(eng.init_state(), 0, np.arange(3))
    st, seed = eng.pause_slot(st, 0)
    assert seed.pos == 3 and not bool(st.active[0])
    with pytest.raises(ValueError, match="ragged_impl"):
        DecodeEngine(tp, tcfg, slots=1, max_len=16, device="cpu",
                     ragged_impl="pallas")


def test_kernel_ragged_impl_raises_on_cpu(models):
    _, tcfg, _, tp = models
    eng = DecodeEngine(tp, tcfg, slots=1, max_len=16, page_size=PAGE,
                       device="cpu", ragged_impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        eng.serve([np.arange(3)], max_new=3)
    # the plain path is the same engine with "torch"
    eng = DecodeEngine(tp, tcfg, slots=1, max_len=16, page_size=PAGE,
                       device="cpu", ragged_impl="torch")
    assert len(eng.serve([np.arange(3)], max_new=3)[0]) == 3
    assert isinstance(eng.last_stats.steps, int)
    assert torch.is_tensor(eng.init_state().page_table)
