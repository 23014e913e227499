"""The port's speculative decoding held against the live JAX package: the
verify rules on the same logits (with the JAX keys' uniforms and Gumbel
draws injected into the sampled rule), and `serve(speculative=True)` on
float and int8 pools, with the same weights and prompts.

Tolerances: tokens, accepted counts and the round ledger are exactly
equal; log-probabilities within 1e-6 for the rules (one float32
log-softmax on each side) and 1e-4 through the engine (float32 logits
of unit scale through a few layers, summed in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sampling as JS
from paddle_tpu.serve.engine import DecodeEngine as JEngine
from paddle_tpu_torch.ops import sampling as TS
from paddle_tpu_torch.serve.engine import DecodeEngine
from paddle_tpu_torch.serve.speculative import NGramProposer
from torch_parity import make_models, to_jax, to_torch

CFG = dict(vocab=61, dim=32, n_layers=2, n_heads=4)
PAGE = 4


def _np(x):
    return np.asarray(jax.device_get(x))


def _window(seed, s, k, v, *, boost=0.0):
    """Logits [S, K+1, V] and a window whose drafts follow the argmax for
    a random prefix of each row (so some are accepted), then diverge.
    boost raises each draft's logit so sampled rows accept it too."""
    rs = np.random.RandomState(seed)
    logits = rs.standard_normal((s, k + 1, v)).astype(np.float32) * 2
    window = rs.randint(0, v, (s, k + 1)).astype(np.int32)
    agree = rs.randint(0, k + 1, s)
    for r in range(s):
        for j in range(agree[r]):
            window[r, j + 1] = logits[r, j].argmax()
        for j in range(k):
            logits[r, j, window[r, j + 1]] += boost
    draft_len = rs.randint(0, k + 1, s).astype(np.int32)
    return logits, window, draft_len


@pytest.mark.parametrize("k", [0, 1, 4])
def test_greedy_spec_verify_matches_jax(k):
    logits, window, dl = _window(k, 7, k, 40)
    ref = JS.greedy_spec_verify(to_jax(logits), to_jax(window), to_jax(dl))
    got = TS.greedy_spec_verify(to_torch(logits), to_torch(window).long(),
                                to_torch(dl))
    np.testing.assert_array_equal(got[0].numpy(), _np(ref[0]))   # next
    np.testing.assert_array_equal(got[1].numpy(), _np(ref[1]))   # n_acc
    for g, r in zip(got[2:], ref[2:]):
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _np(r), atol=1e-6, rtol=0)
    if k:
        assert got[1].max() > 0                  # some drafts accepted
        assert (got[1] <= to_torch(dl)).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_spec_verify_matches_jax_with_injected_draws(seed):
    s, k, v = 6, 3, 40
    logits, window, dl = _window(seed, s, k, v, boost=3.0)
    temp = np.array([0.0, 0.7, 1.0, 0.0, 1.3, 0.5], np.float32)
    top_k = np.array([v, 5, v, v, 10, 1], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 1.0, 0.8, 1.0], np.float32)
    rng = jax.random.split(jax.random.key(seed), s)
    ref = JS.ngram_spec_verify(to_jax(logits), to_jax(window), to_jax(dl),
                               to_jax(temp), to_jax(top_k), to_jax(top_p),
                               rng)
    # the draws the JAX rule makes from its per-row keys
    keys = jax.vmap(lambda r: jax.random.split(r, 2))(rng)
    u = jax.vmap(lambda r: jax.random.uniform(r, (k,)))(keys[:, 0])
    noise = jax.vmap(lambda r: jax.random.gumbel(r, (v,), jnp.float32))(
        keys[:, 1])
    got = TS.ngram_spec_verify(
        to_torch(logits), to_torch(window).long(), to_torch(dl),
        to_torch(temp), to_torch(top_k), to_torch(top_p),
        u=to_torch(_np(u)), noise=to_torch(_np(noise)))
    np.testing.assert_array_equal(got[0].numpy(), _np(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), _np(ref[1]))
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g.numpy(), _np(r), atol=1e-6, rtol=0)
    # greedy rows follow the greedy rule
    greedy = TS.greedy_spec_verify(to_torch(logits), to_torch(window).long(),
                                   to_torch(dl))
    for r in (0, 3):
        assert got[0][r] == greedy[0][r] and got[1][r] == greedy[1][r]


def test_ngram_spec_verify_draws_from_row_generators():
    logits, window, dl = _window(5, 4, 3, 30, boost=1.0)
    args = (to_torch(logits), to_torch(window).long(), to_torch(dl),
            torch.ones(4), torch.full((4,), 30), torch.ones(4))
    gens = lambda: [torch.Generator().manual_seed(i) for i in range(4)]
    a = TS.ngram_spec_verify(*args, generators=gens())
    b = TS.ngram_spec_verify(*args, generators=gens())
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    assert ((a[1] >= 0) & (a[1] <= to_torch(dl))).all()


# -- the engine ----------------------------------------------------------


class _Models(tuple):
    """make_models' tuple, hashable by identity (the engine cache key)."""

    __hash__ = object.__hash__
    __eq__ = object.__eq__


# an embedding scale at which the random model's greedy output varies
# (21 distinct tokens over the float test's requests) and still falls
# into loops that the n-gram proposer drafts correctly
EMBED_STD = 0.3


@pytest.fixture(scope="module")
def models():
    return _Models(make_models(seed=0, embed_std=EMBED_STD, **CFG))


@pytest.fixture(scope="module")
def int8_models():
    return _Models(make_models(seed=0, embed_std=EMBED_STD,
                               kv_cache_dtype="int8", **CFG))


def _prompts(seed=0, n=6):
    """Repetitive prompts the n-gram proposer bites on, and random ones
    (the JAX package's int8 speculative traffic)."""
    r = np.random.RandomState(seed)
    base = r.randint(0, CFG["vocab"], (6,)).astype(np.int32)
    out = [np.concatenate([base, base, base[:3]]),
           r.randint(0, CFG["vocab"], (7,)),
           np.concatenate([base, base]),
           r.randint(0, CFG["vocab"], (5,)),
           np.concatenate([base[:4], base]),
           r.randint(0, CFG["vocab"], (4,))]
    return [p.astype(np.int32) for p in out[:n]]


@functools.lru_cache(maxsize=None)
def _jax_engine(models, geometry):
    jcfg, _, jp, _ = models
    return JEngine(jp, jcfg, **dict(geometry))


SPEC_STATS = ("steps", "spec_rounds", "draft_proposed", "draft_accepted",
              "spec_reserved", "spec_rolled_back", "retried", "prefix_hits")


def _serve_both(models, prompts, *, max_new, engine_kw):
    _, tcfg, _, tp = models
    j_eng = _jax_engine(models, tuple(sorted(engine_kw.items())))
    t_eng = DecodeEngine(tp, tcfg, device="cpu", **engine_kw)
    kw = dict(max_new=max_new, buckets=(20,), return_logprobs=True,
              speculative=True)
    ref = j_eng.serve(prompts, **kw)
    got = t_eng.serve(prompts, **kw)
    assert got[0] == ref[0]
    np.testing.assert_allclose(np.concatenate(got[1]),
                               np.concatenate(ref[1]), atol=1e-4, rtol=0)
    js, ts = j_eng.last_stats, t_eng.last_stats
    assert ({k: getattr(ts, k) for k in SPEC_STATS}
            == {k: getattr(js, k) for k in SPEC_STATS})
    assert 0 < ts.draft_accepted <= ts.draft_proposed
    return got, ts


GEOM = dict(slots=2, max_len=48, page_size=PAGE)


def test_speculative_serve_matches_jax(models):
    got, st = _serve_both(models, _prompts(0), max_new=10, engine_kw=GEOM)
    assert st.spec_rounds == st.steps > 0
    # fewer rounds than tokens: drafts were accepted
    assert st.tokens > st.spec_rounds
    # and the tokens are the plain greedy engine's
    _, tcfg, _, tp = models
    plain = DecodeEngine(tp, tcfg, device="cpu", **GEOM).serve(
        _prompts(0), max_new=10, buckets=(20,))
    assert got[0] == plain


def test_speculative_serve_on_int8_pool_matches_jax(int8_models):
    got, _ = _serve_both(int8_models, _prompts(2)[:4], max_new=10,
                         engine_kw=GEOM)
    _, tcfg, _, tp = int8_models
    plain = DecodeEngine(tp, tcfg, device="cpu", **GEOM).serve(
        _prompts(2)[:4], max_new=10, buckets=(20,))
    assert got[0] == plain


def test_speculative_serve_oversubscribed_matches_jax(models):
    # 3 slots of 12 pages each would be dense; 12 pages in all force
    # page exhaustion: 0-draft rounds and preemption
    _, st = _serve_both(models, _prompts(1), max_new=12,
                        engine_kw=dict(slots=3, max_len=48, page_size=PAGE,
                                       num_pages=12))
    assert st.retried > 0
    assert st.spec_rolled_back > 0


def test_speculative_serve_eos_matches_jax(models):
    _, tcfg, _, tp = models
    prompts = _prompts(3, n=3)
    first = DecodeEngine(tp, tcfg, device="cpu", **GEOM).serve(
        prompts, max_new=8, buckets=(20,))
    eos = first[0][3]
    got, _ = _serve_both(models, prompts, max_new=8,
                         engine_kw=dict(GEOM, eos_id=eos))
    assert got[0][0][-1] == eos and len(got[0][0]) <= 4


def test_sampled_speculative_serve_is_seed_deterministic(models):
    _, tcfg, _, tp = models
    prompts = _prompts(4, n=3)
    samp = [{"temperature": 1.0, "top_k": 20, "seed": 7}, {},
            {"temperature": 0.8, "top_p": 0.9, "seed": 3}]
    mk = lambda: DecodeEngine(tp, tcfg, device="cpu", **GEOM)
    a = mk().serve(prompts, max_new=8, sampling=samp, speculative=True)
    b = mk().serve(prompts, max_new=8, sampling=samp, speculative=True)
    greedy = mk().serve(prompts, max_new=8)
    assert a == b
    assert a[1] == greedy[1]        # the greedy co-tenant is unperturbed
    assert all(len(t) == 8 for t in a)


def test_speculative_serve_validation_and_custom_proposer(models):
    _, tcfg, _, tp = models
    eng = DecodeEngine(tp, tcfg, device="cpu", **GEOM)

    class Fixed:
        """A proposer with only propose(): always drafts token 0."""

        def propose(self, history, k):
            return [0] * k

    out = eng.serve(_prompts(5, n=2), max_new=6, speculative=True,
                    proposer=Fixed())
    assert [len(t) for t in out] == [6, 6]
    assert eng.last_stats.draft_proposed > 0
    assert isinstance(NGramProposer().propose([1, 2, 1, 2, 1], 2), list)
    eng.policy.spec_draft_max = 0
    with pytest.raises(ValueError, match="spec_draft_max"):
        eng.serve(_prompts(5, n=1), max_new=2, speculative=True)


def test_verify_window_past_max_len_leaves_the_cache_alone():
    # max_len 16 = the whole 4-page table; a window from pos 14 covers
    # 14..17: 16 and 17 are padding past the cache and must be dropped,
    # not clipped onto the row's last page (positions 12 and 13)
    from paddle_tpu_torch.ops import paged_attention as PA

    rs = np.random.RandomState(0)
    arena = lambda: torch.from_numpy(
        rs.standard_normal((5, PAGE, 1, 8)).astype(np.float32))
    ka, va = arena(), arena()
    before = ka.clone(), va.clone()
    table = torch.tensor([[1, 3, 0, 2]], dtype=torch.int32)
    new = lambda h: torch.from_numpy(
        rs.standard_normal((1, 4, h, 8)).astype(np.float32))
    PA.paged_verify_attention(new(2), new(1), new(1), ka, va, table,
                              torch.tensor([14], dtype=torch.int32),
                              torch.tensor([True]), page_size=PAGE,
                              max_len=16)
    for got, old in zip((ka, va), before):
        changed = (got != old).any(dim=(2, 3)).nonzero().tolist()
        assert changed == [[2, 2], [2, 3]]     # positions 14, 15 only


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_speculative_tokens_equal_decode_up_to_the_cache_end(kv):
    # requests run into max_len, where the padded verify window reaches
    # past the cache
    import dataclasses

    _, tcfg, _, tp = make_models(seed=0, embed_std=EMBED_STD, **CFG)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    eng = DecodeEngine(tp, tcfg, device="cpu", slots=2, max_len=24,
                       page_size=PAGE)
    prompts = _prompts(6, n=4)
    plain = eng.serve(prompts, max_new=30)
    spec = eng.serve(prompts, max_new=30, speculative=True)
    assert spec == plain
    assert [len(t) for t in plain] == [24 - len(p) for p in prompts]
    assert eng.last_stats.draft_accepted > 0
