"""The port's per-row sampler held against the JAX sampler: filtering is
float32 arithmetic on the same logits (within 1e-5, the same -inf
pattern), and with the Gumbel noise that `jax.random.categorical` draws
injected, the sampled tokens are exactly JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sampling as JS
from paddle_tpu_torch.ops import sampling as TS
from torch_parity import to_jax, to_torch


def _batch(seed, n=6, v=40):
    rs = np.random.RandomState(seed)
    logits = rs.standard_normal((n, v)).astype(np.float32)
    temp = np.array([0.0, 0.5, 1.0, 1.5, 0.7, 1.0], np.float32)[:n]
    top_k = np.array([v, 5, 1, 100, 12, v], np.int32)[:n]
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.75, 0.3], np.float32)[:n]
    return logits, temp, top_k, top_p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_logits_match_jax(seed):
    logits, temp, top_k, top_p = _batch(seed)
    # the filter takes temp > 0; a moderate spread keeps every tail
    # token's preceding nucleus mass clear of 1.0, where float32 cumsum
    # rounding (not the algorithm) decides the comparison with top_p
    temp = np.maximum(temp, 0.5)
    ref = np.asarray(JS.per_row_filter_logits(
        to_jax(logits), to_jax(temp), to_jax(top_k), to_jax(top_p)))
    got = TS.per_row_filter_logits(
        to_torch(logits), to_torch(temp), to_torch(top_k),
        to_torch(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_with_injected_noise_matches_jax(seed):
    logits, temp, top_k, top_p = _batch(seed)
    key = jax.random.key(seed)
    ref = np.asarray(JS.per_row_sample(
        to_jax(logits), to_jax(temp), to_jax(top_k), to_jax(top_p), key))
    noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = TS.per_row_sample(
        to_torch(logits), to_torch(temp), to_torch(top_k), to_torch(top_p),
        noise=to_torch(noise)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0] == logits[0].argmax()        # temperature 0 is greedy
    assert got[2] == logits[2].argmax()        # top_k 1 is greedy too


def test_per_row_generators_are_independent_streams():
    logits, temp, top_k, top_p = (to_torch(x) for x in _batch(3))
    temp = torch.ones_like(temp)
    top_k = torch.full_like(top_k, 40)
    top_p = torch.ones_like(top_p)
    gens = lambda s: [torch.Generator().manual_seed(s + i) for i in range(6)]
    a = TS.per_row_sample(logits, temp, top_k, top_p, generators=gens(0))
    b = TS.per_row_sample(logits, temp, top_k, top_p, generators=gens(0))
    torch.testing.assert_close(a, b)
    # row 0's draw depends on its own stream only
    g = gens(0)
    g[3] = torch.Generator().manual_seed(999)
    c = TS.per_row_sample(logits, temp, top_k, top_p, generators=g)
    assert c[0] == a[0]


def test_gumbel_noise_is_standard_gumbel():
    g = TS.gumbel_noise((200000,), generator=torch.Generator().manual_seed(0))
    assert abs(g.mean().item() - 0.5772) < 0.01       # Euler-Mascheroni
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.03
