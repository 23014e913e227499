"""The port's remaining LM decoders held against the live JAX package on
the same weights: sampled `generate`/`sample` with JAX's own Gumbel
draws injected (tokens exact), `make_sampler`'s filter (ties at the
k-th logit survive), `beam_decode` (sequences exact, scores 1e-4),
`speculative_generate` (tokens and per-row rounds exact, equal to
greedy `generate`) and `speculative_sample` (top_k=1 equal to JAX's
greedy; the first token's distribution the target's filtered softmax
within 0.05 over 2000 rows, as JAX's own test holds it).

The JAX decoders run under jax.jit: their eager first calls compile
scans and while loops op by op (seconds each)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as JT
from paddle_tpu.serve import quant as JQ
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.weights import params_from_numpy
from torch_parity import make_models, to_jax, to_torch

CFG = dict(vocab=32, dim=16, n_layers=2, n_heads=2, mlp_ratio=2,
           attn_impl="dense")
DRAFT = dict(CFG, dim=8, n_layers=1)


def target(seed=0, **kw):
    return make_models(seed=seed, embed_std=0.3, **dict(CFG, **kw))


def draft(seed=9, **kw):
    return make_models(seed=seed, embed_std=0.3, **dict(DRAFT, **kw))


def prompts(b, t0, seed, vocab=32):
    return np.random.RandomState(seed).randint(1, vocab, (b, t0)).astype(
        np.int32)


def jax_generate(jp, jcfg, prompt, steps, **kw):
    return np.asarray(jax.jit(lambda p, pr: JT.generate(
        p, jcfg, pr, steps, **kw))(jp, to_jax(prompt)))


# -- sampling ----------------------------------------------------------------


def jax_gumbel_stream(key, n, shape):
    """The Gumbel draws jax's generate(select_fn=sampler, rng=key) makes,
    in order: the first token's (split once), then one per scan step."""
    rng, first = jax.random.split(key)
    out = [jax.random.gumbel(first, shape, jnp.float32)]
    for _ in range(n - 1):
        rng, step = jax.random.split(rng)
        out.append(jax.random.gumbel(step, shape, jnp.float32))
    return [to_torch(g) for g in out]


def injected(draws):
    it = iter(draws)
    return lambda shape: next(it)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.8, None, 0.95), (1.0, 5, None), (0.7, 8, 0.9), (1.3, None, None),
    (0.0, None, None)])
def test_sample_with_jax_gumbel_draws_matches_jax(temperature, top_k, top_p):
    jcfg, tcfg, jp, tp = target(seed=1)
    prompt, steps, key = prompts(3, 6, seed=4), 8, jax.random.key(4)
    want = np.asarray(jax.jit(lambda p, pr, k: JT.sample(
        p, jcfg, pr, steps, k, temperature=temperature, top_k=top_k,
        top_p=top_p))(jp, to_jax(prompt), key))
    got = TT.sample(tp, tcfg, to_torch(prompt), steps,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    noise=injected(jax_gumbel_stream(key, steps, (3, 32))))
    np.testing.assert_array_equal(got.numpy(), want)
    if temperature > 0:
        greedy = TT.generate(tp, tcfg, to_torch(prompt), steps).numpy()
        assert (greedy != want).any()        # the draws mattered


def test_sample_with_eos_and_prompt_lens_matches_jax():
    jcfg, tcfg, jp, tp = target(seed=2)
    prompt, steps, key = prompts(3, 7, seed=5), 9, jax.random.key(8)
    lens = np.array([7, 4, 2], np.int32)
    free = TT.sample(tp, tcfg, to_torch(prompt), steps, temperature=0.9,
                     top_k=10, prompt_lens=to_torch(lens),
                     noise=injected(jax_gumbel_stream(key, steps, (3, 32))))
    eos = int(free[0, 9])
    want = np.asarray(jax.jit(lambda p, pr, k, ln: JT.sample(
        p, jcfg, pr, steps, k, temperature=0.9, top_k=10, eos_id=eos,
        pad_id=0, prompt_lens=ln))(jp, to_jax(prompt), key, to_jax(lens)))
    got = TT.sample(tp, tcfg, to_torch(prompt), steps, temperature=0.9,
                    top_k=10, eos_id=eos, pad_id=0,
                    prompt_lens=to_torch(lens),
                    noise=injected(jax_gumbel_stream(key, steps, (3, 32))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, 10:] == 0).all()


def test_generate_select_fn_gets_the_generator_once_a_step():
    _, tcfg, _, tp = target(seed=3)
    prompt = to_torch(prompts(2, 5, seed=6))
    seen = []

    def select(logits, rng):
        seen.append(rng)
        return torch.argmax(logits, dim=-1)

    g = torch.Generator().manual_seed(1)
    out = TT.generate(tp, tcfg, prompt, 6, select_fn=select, rng=g)
    assert len(seen) == 6 and all(r is g for r in seen)
    np.testing.assert_array_equal(out.numpy(),
                                  TT.generate(tp, tcfg, prompt, 6).numpy())
    # the port's own draws: seeded generators repeat, others differ
    runs = [TT.sample(tp, tcfg, prompt, 6, torch.Generator().manual_seed(s))
            for s in (0, 0, 5)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                              runs[2])


@pytest.mark.parametrize("top_k,top_p", [(3, None), (None, 0.5), (4, 0.8),
                                         (100, None)])
def test_filter_logits_matches_jax_and_keeps_ties(top_k, top_p):
    rs = np.random.RandomState(0)
    logits = rs.randint(-3, 4, (6, 16)).astype(np.float32)  # many ties
    want = np.asarray(JT._filter_logits(to_jax(logits), 0.7, top_k, top_p))
    got = TT._filter_logits(to_torch(logits), 0.7, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-7)
    if top_k == 3:
        assert (np.isfinite(got).sum(axis=1) >= 3).all()
        assert (np.isfinite(got).sum(axis=1) > 3).any()     # ties survive
    for bad in (dict(temperature=-1.0), dict(top_k=0), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError):
            TT.make_sampler(**bad)


# -- beam search -------------------------------------------------------------


def jax_beam(jp, jcfg, prompt, steps, k, **kw):
    s, sc = jax.jit(lambda p, pr: JT.beam_decode(p, jcfg, pr, steps, k,
                                                 **kw))(jp, to_jax(prompt))
    return np.asarray(s), np.asarray(sc)


@pytest.mark.parametrize("k,penalty", [(3, 0.0), (4, 0.6), (1, 0.0)])
def test_beam_decode_matches_jax(k, penalty):
    jcfg, tcfg, jp, tp = target(seed=1)
    prompt = prompts(2, 6, seed=1)
    want_s, want_sc = jax_beam(jp, jcfg, prompt, 6, k,
                               length_penalty=penalty)
    got_s, got_sc = TT.beam_decode(tp, tcfg, to_torch(prompt), 6, k,
                                   length_penalty=penalty)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_allclose(got_sc.numpy(), want_sc, rtol=1e-4, atol=0)
    if k == 1:
        np.testing.assert_array_equal(
            got_s[:, 0].numpy(),
            TT.generate(tp, tcfg, to_torch(prompt), 6).numpy())


def test_beam_decode_with_eos_matches_jax():
    jcfg, tcfg, jp, tp = target(seed=2)
    prompt = prompts(2, 5, seed=2)
    free, _ = TT.beam_decode(tp, tcfg, to_torch(prompt), 6, 2)
    eos = int(free[0, 0, 5])
    want_s, want_sc = jax_beam(jp, jcfg, prompt, 6, 2, eos_id=eos)
    got_s, got_sc = TT.beam_decode(tp, tcfg, to_torch(prompt), 6, 2,
                                   eos_id=eos)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_allclose(got_sc.numpy(), want_sc, rtol=1e-4)
    assert (want_s[0, :, 5:] == eos).any()


def test_beam_decode_int8_weights_window_and_one_token_prompt():
    jcfg, tcfg, jp, tp = target(seed=5, attn_window=4)
    qj = JQ.quantize_params(jp)
    qt = params_from_numpy(jax.device_get(qj), device="cpu")
    prompt = prompts(2, 6, seed=5)
    want_s, want_sc = jax_beam(qj, jcfg, prompt, 5, 2)
    got_s, got_sc = TT.beam_decode(qt, tcfg, to_torch(prompt), 5, 2)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_allclose(got_sc.numpy(), want_sc, rtol=1e-4)
    one = np.array([[5], [17]], np.int32)
    want_s, want_sc = jax_beam(jp, jcfg, one, 4, 3)
    got_s, got_sc = TT.beam_decode(tp, tcfg, to_torch(one), 4, 3)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_allclose(got_sc.numpy(), want_sc, rtol=1e-4)


# -- speculative decoding ------------------------------------------------------


def jax_spec(jp, jcfg, jdp, djcfg, prompt, steps, **kw):
    out, rounds = jax.jit(lambda p, dp, pr: JT.speculative_generate(
        p, jcfg, dp, djcfg, pr, steps, return_stats=True, **kw))(
            jp, jdp, to_jax(prompt))
    return np.asarray(out), np.asarray(rounds)


@pytest.mark.parametrize("k,b", [(1, 1), (3, 3), (5, 2)])
def test_speculative_generate_matches_jax_and_greedy(k, b):
    jcfg, tcfg, jp, tp = target()
    djcfg, dtcfg, jdp, tdp = draft()
    prompt = prompts(b, 6, seed=k)
    want, want_r = jax_spec(jp, jcfg, jdp, djcfg, prompt, 9, draft_k=k)
    got, got_r = TT.speculative_generate(tp, tcfg, tdp, dtcfg,
                                         to_torch(prompt), 9, draft_k=k,
                                         return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(
        got.numpy(), TT.generate(tp, tcfg, to_torch(prompt), 9).numpy())


def test_speculative_generate_perfect_draft_and_gqa():
    jcfg, tcfg, jp, tp = target(seed=2, n_heads=4, n_kv_heads=1)
    prompt = prompts(2, 5, seed=1)
    want, want_r = jax_spec(jp, jcfg, jp, jcfg, prompt, 10, draft_k=4)
    got, got_r = TT.speculative_generate(tp, tcfg, tp, tcfg,
                                         to_torch(prompt), 10, draft_k=4,
                                         return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    assert got_r.tolist() == [2, 2]      # ceil(10 / 5) rounds a row


def test_speculative_generate_eos_matches_jax():
    jcfg, tcfg, jp, tp = target()
    djcfg, dtcfg, jdp, tdp = draft()
    prompt = prompts(2, 5, seed=5)
    plain = TT.generate(tp, tcfg, to_torch(prompt), 10).numpy()
    eos = int(plain[0, 7])
    want, want_r = jax_spec(jp, jcfg, jdp, djcfg, prompt, 10, draft_k=3,
                            eos_id=eos, pad_id=0)
    got, got_r = TT.speculative_generate(tp, tcfg, tdp, dtcfg,
                                         to_torch(prompt), 10, draft_k=3,
                                         eos_id=eos, pad_id=0,
                                         return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got.numpy(), TT.generate(
        tp, tcfg, to_torch(prompt), 10, eos_id=eos, pad_id=0).numpy())
    assert int(got_r[0]) < 10


def test_beam_and_speculative_respect_the_window():
    jcfg, tcfg, jp, tp = target(seed=3, attn_window=4)
    djcfg, dtcfg, jdp, tdp = draft(seed=4, attn_window=4)
    prompt = prompts(1, 6, seed=3)
    greedy = TT.generate(tp, tcfg, to_torch(prompt), 5).numpy()
    seqs, _ = TT.beam_decode(tp, tcfg, to_torch(prompt), 5, 1)
    np.testing.assert_array_equal(seqs[:, 0].numpy(), greedy)
    want, want_r = jax_spec(jp, jcfg, jdp, djcfg, prompt, 5, draft_k=3)
    got, got_r = TT.speculative_generate(tp, tcfg, tdp, dtcfg,
                                         to_torch(prompt), 5, draft_k=3,
                                         return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got.numpy(), greedy)


def test_speculative_int8_target_and_refusals():
    jcfg, tcfg, jp, tp = target()
    djcfg, dtcfg, jdp, tdp = draft()
    qj = JQ.quantize_params(jp)
    qt = params_from_numpy(jax.device_get(qj), device="cpu")
    prompt = prompts(2, 6, seed=6)
    want, want_r = jax_spec(qj, jcfg, jdp, djcfg, prompt, 7, draft_k=3)
    got, got_r = TT.speculative_generate(qt, tcfg, tdp, dtcfg,
                                         to_torch(prompt), 7, draft_k=3,
                                         return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    kv8 = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    p = to_torch(prompt)
    for call in (lambda: TT.speculative_generate(tp, kv8, tdp, dtcfg, p, 3),
                 lambda: TT.speculative_sample(tp, tcfg, tdp, kv8, p, 3),
                 lambda: TT.beam_decode(tp, kv8, p, 3)):
        with pytest.raises(ValueError, match="int8"):
            call()
    with pytest.raises(ValueError, match="prompt"):
        TT.speculative_generate(tp, tcfg, tdp, dtcfg, p[:, :1], 3)
    with pytest.raises(ValueError, match="temperature"):
        TT.speculative_sample(tp, tcfg, tdp, dtcfg, p, 3, temperature=0.0)


def test_speculative_sample_top_k1_equals_jax_greedy():
    jcfg, tcfg, jp, tp = target(vocab=16)
    djcfg, dtcfg, jdp, tdp = draft(vocab=16)
    prompt = prompts(2, 5, seed=1, vocab=16)
    want = jax_generate(jp, jcfg, prompt, 8)
    got, rounds = TT.speculative_sample(
        tp, tcfg, tdp, dtcfg, to_torch(prompt), 8,
        torch.Generator().manual_seed(3), draft_k=3, top_k=1,
        return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # JAX's sampler at top_k=1 reproduces the same tokens
    jout = np.asarray(jax.jit(lambda p, dp, pr, k: JT.speculative_sample(
        p, jcfg, dp, djcfg, pr, 8, k, draft_k=3, top_k=1))(
            jp, jdp, to_jax(prompt), jax.random.key(3)))
    np.testing.assert_array_equal(got.numpy(), jout)


def test_speculative_sample_first_token_distribution():
    jcfg, tcfg, jp, tp = target(seed=0, vocab=16)
    djcfg, dtcfg, jdp, tdp = draft(vocab=16)
    row = prompts(1, 4, seed=0, vocab=16)
    prompt = to_torch(np.repeat(row, 2000, axis=0))
    out = TT.speculative_sample(tp, tcfg, tdp, dtcfg, prompt, 1,
                                torch.Generator().manual_seed(42),
                                draft_k=2, temperature=0.9)
    freq = np.bincount(out[:, 4].numpy(), minlength=16) / 2000.0
    logits = np.asarray(JT.apply(jp, jcfg, to_jax(row)))[0, -1]
    want = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32) / 0.9))
    assert np.abs(freq - want).max() < 0.05, (freq, want)


def test_speculative_sample_perfect_draft_and_eos():
    _, tcfg, _, tp = target(vocab=16)
    _, dtcfg, _, tdp = draft(vocab=16)
    prompt = to_torch(prompts(2, 4, seed=2, vocab=16))
    _, rounds = TT.speculative_sample(tp, tcfg, tp, tcfg, prompt, 10,
                                      torch.Generator().manual_seed(7),
                                      draft_k=4, temperature=0.8,
                                      return_stats=True)
    assert rounds.tolist() == [2, 2]     # p == q: every draft holds
    out, rounds = TT.speculative_sample(tp, tcfg, tdp, dtcfg, prompt, 12,
                                        torch.Generator().manual_seed(5),
                                        draft_k=3, temperature=1.0, eos_id=3,
                                        pad_id=0, return_stats=True)
    assert out.shape == (2, 16)
    for r in range(2):
        gen = out[r, 4:].numpy()
        hits = np.flatnonzero(gen == 3)
        if hits.size:
            assert (gen[hits[0] + 1:] == 0).all(), gen
