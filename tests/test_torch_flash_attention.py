"""The port's flash-attention plain version held against the JAX flash
kernel run in interpret mode (the JAX package's own CPU route), output
and row log-sum-exp, on the same inputs.

Tolerance: float32, 1e-5 -- the two sum the same unit-scale products in
another order (the JAX kernel streams 256x512 blocks, the plain version
takes one softmax)."""

import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as JFA
from paddle_tpu_torch.ops import flash_attention as FA
from torch_parity import np_f32, to_jax, to_torch

TOL = 1e-5

CASES = [
    dict(name="full", causal=False, lens=None, window=None),
    dict(name="causal", causal=True, lens=None, window=None),
    dict(name="key_lens", causal=True, lens=[5, 12], window=None),
    dict(name="no_valid_key", causal=False, lens=[0, 7], window=None),
    dict(name="window", causal=True, lens=[12, 9], window=4),
]


def _inputs(seed, b=2, t=12, h=3, d=8):
    rs = np.random.RandomState(seed)
    return np_f32(rs, b, t, h, d), np_f32(rs, b, t, h, d), np_f32(
        rs, b, t, h, d)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_flash_plain_version_matches_jax_kernel(case):
    q, k, v = _inputs(0)
    key_lens = case["lens"]
    j_lens = None if key_lens is None else to_jax(np.array(key_lens))
    t_lens = None if key_lens is None else torch.tensor(key_lens)
    ref = JFA.flash_attention(to_jax(q), to_jax(k), to_jax(v),
                              causal=case["causal"], key_lens=j_lens,
                              window=case["window"])
    got = FA.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                             causal=case["causal"], key_lens=t_lens,
                             window=case["window"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)
    # the row log-sum-exp, against the JAX kernel's launcher
    b, t, h, d = q.shape
    lens = np.full((b,), t) if key_lens is None else np.array(key_lens)
    _, lse = FA.flash_attention_reference(
        to_torch(q), to_torch(k), to_torch(v),
        torch.from_numpy(lens.astype(np.int32)), causal=case["causal"],
        window=case["window"])
    flat = lambda x: to_jax(x.transpose(0, 2, 1, 3).reshape(b * h, t, d))
    _, j_lse = JFA._flash_forward(
        flat(q), flat(k), flat(v), to_jax(np.repeat(lens, h)),
        causal=case["causal"], block_q=JFA.DEFAULT_BLOCK_Q,
        block_k=JFA.DEFAULT_BLOCK_K, window=case["window"], interpret=True)
    j_lse = np.asarray(j_lse).reshape(b, h, t)
    live = j_lse > -1e29                    # rows with >= 1 valid key
    np.testing.assert_allclose(lse.numpy()[live], j_lse[live], atol=TOL,
                               rtol=1e-6)
    np.testing.assert_array_equal(lse.numpy() <= -1e29, ~live)
    if case["name"] == "no_valid_key":
        assert np.abs(got.numpy()[0]).max() == 0.0


def test_flash_reference_rounds_pv_operand_in_bf16():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(1))
    lens = torch.tensor([12, 12], dtype=torch.int32)
    o, _ = FA.flash_attention_reference(q, k, v, lens, causal=True)
    o32, _ = FA.flash_attention_reference(q.float(), k.float(), v.float(),
                                          lens, causal=True)
    assert o.dtype == torch.bfloat16
    # bf16 output within bf16 rounding of the f32 computation
    torch.testing.assert_close(o.float(), o32, atol=2e-2, rtol=0)


def test_flash_attention_checks():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2))
    with pytest.raises(ValueError, match="Tq == Tkv"):
        FA.flash_attention(q[:, :5], k, v, causal=True)
    with pytest.raises(ValueError, match="window requires causal"):
        FA.flash_attention(q, k, v, causal=False, window=3)
    with pytest.raises(ValueError, match="key_lens must be"):
        FA.flash_attention(q, k, v, key_lens=torch.tensor([3]))
    # differentiable: gradients reach q, k and v
    q.requires_grad_()
    dq, dk = torch.autograd.grad(
        FA.flash_attention(q, k.requires_grad_(), v).sum(), (q, k))
    assert dq.shape == q.shape and dk.shape == k.shape
    assert torch.isfinite(dq).all() and dq.abs().max() > 0


def test_flash_kernel_takes_cuda_tensors_only():
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, d=64))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        FA.flash_kernel(q, k, v, torch.full((2,), 12, dtype=torch.int32),
                        causal=True)


def test_out_of_range_key_lens_clamp_to_no_mask():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4))
    a = FA.flash_attention(q, k, v, key_lens=torch.tensor([99, 12]))
    b = FA.flash_attention(q, k, v)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
