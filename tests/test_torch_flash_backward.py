"""The port's flash-attention gradients (on CPU tensors: the plain forward
and the ported blockwise backward) held against `jax.grad` of the JAX
package's flash attention (its Pallas forward in interpret mode and its
plain-JAX backward, jitted) and against `torch.autograd` through the
port's plain version, on the same inputs and random cotangents.

Tolerances, on max abs error over max(1, max |reference|): float32 1e-5
(the same products summed in another order), bfloat16 2e-2 (o and the
gradients are rounded to bf16 on both sides)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as JFA
from paddle_tpu_torch.ops import flash_attention as FA
from torch_parity import np_f32, to_jax, to_torch

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
B, T, H, D = 2, 40, 2, 8
BLOCK_K = 16            # T is not a multiple of the key block

CASES = [
    dict(name="full", causal=False, lens=None, window=None),
    dict(name="causal", causal=True, lens=None, window=None),
    dict(name="lens_zero_and_overlong", causal=False, lens=[0, 55],
         window=None),
    dict(name="causal_lens", causal=True, lens=[23, 40], window=None),
    dict(name="window", causal=True, lens=[40, 31], window=7),
    dict(name="window_ge_t", causal=True, lens=None, window=64),
    dict(name="bf16_causal", causal=True, lens=[40, 17], window=None,
         dtype=torch.bfloat16),
    dict(name="bf16_window", causal=True, lens=None, window=9,
         dtype=torch.bfloat16),
]


def _inputs(seed):
    rs = np.random.RandomState(seed)
    return [np_f32(rs, B, T, H, D) for _ in range(4)]     # q, k, v, g


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _port_grads(case, q, k, v, g, **kw):
    dtype = case.get("dtype", torch.float32)
    qt, kt, vt = (to_torch(x).to(dtype).requires_grad_() for x in (q, k, v))
    lens = None if case["lens"] is None else torch.tensor(case["lens"])
    o = FA.flash_attention(qt, kt, vt, causal=case["causal"], key_lens=lens,
                           window=case["window"], **kw)
    grads = torch.autograd.grad(o, (qt, kt, vt), to_torch(g).to(dtype))
    assert all(x.dtype == dtype for x in grads)
    return grads


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(causal, window, has_lens):
    def f(q, k, v, g, lens):
        o = JFA.flash_attention(q, k, v, causal=causal, block_k=BLOCK_K,
                                key_lens=lens if has_lens else None,
                                window=window)
        return jnp.sum(o.astype(jnp.float32) * g)

    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_flash_gradients_match_jax(case):
    q, k, v, g = _inputs(0)
    dtype = case.get("dtype", torch.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    has_lens = case["lens"] is not None
    lens = to_jax(np.array(case["lens"] if has_lens else [T] * B, np.int32))
    ref = _jax_grad_fn(case["causal"], case["window"], has_lens)(
        *(to_jax(x).astype(jdt) for x in (q, k, v)), to_jax(g), lens)
    got = _port_grads(case, q, k, v, g, block_k=BLOCK_K)
    for name, a, b in zip("qkv", got, ref):
        _close(a, np.asarray(b.astype(jnp.float32)), TOL[dtype])


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_flash_gradients_match_autograd_of_plain_version(case):
    q, k, v, g = _inputs(1)
    dtype = case.get("dtype", torch.float32)
    qt, kt, vt = (to_torch(x).to(dtype).requires_grad_() for x in (q, k, v))
    lens = torch.tensor(case["lens"] if case["lens"] is not None
                        else [T] * B).clamp(max=T).to(torch.int32)
    o, _ = FA.flash_attention_reference(qt, kt, vt, lens,
                                        causal=case["causal"],
                                        window=case["window"])
    ref = torch.autograd.grad(o, (qt, kt, vt), to_torch(g).to(dtype))
    got = _port_grads(case, q, k, v, g, block_k=BLOCK_K)
    for a, b in zip(got, ref):
        _close(a, b.float().numpy(), TOL[dtype])


def test_block_sizes_change_no_gradient_beyond_rounding():
    """block_k only reorders the backward's sums; block_q changes
    nothing; a window as wide as T is full causal attention."""
    q, k, v, g = _inputs(2)
    case = dict(causal=True, lens=[40, 29], window=None)
    base = _port_grads(case, q, k, v, g)
    for kw in (dict(block_k=7), dict(block_k=40, block_q=3)):
        for a, b in zip(_port_grads(case, q, k, v, g, **kw), base):
            _close(a, b.numpy(), 1e-6)
    wide = _port_grads(dict(case, window=T), q, k, v, g, block_k=BLOCK_K)
    for a, b in zip(wide, base):
        _close(a, b.numpy(), 1e-6)


def test_rows_without_a_valid_key_get_zero_gradients():
    q, k, v, g = _inputs(3)
    dq, dk, dv = _port_grads(dict(causal=False, lens=[0, 12], window=None),
                             q, k, v, g, block_k=BLOCK_K)
    assert dq[0].abs().max() == 0 and dk[0].abs().max() == 0
    assert dv[0].abs().max() == 0
    assert dk[1, 12:].abs().max() == 0 and dv[1, 12:].abs().max() == 0
    with pytest.raises(ValueError, match="block_q and block_k"):
        FA.flash_attention(*(to_torch(x) for x in (q, k, v)), block_k=0)
