"""Dense linear algebra with dtype policy (mirror of
`paddle_tpu.ops.linalg`). Kernels are stored `[in, out]` and applied as
`x @ W`; the products go to `torch.matmul` and `torch.einsum`, as the
JAX package leaves them to XLA. Beside `matmul` and `dense`: the
reference's row-wise layers (multiplex, bilinear tensor product, cyclic
shift, dot and outer products, convex combination, selective fc)."""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.core.dtypes import Policy, default_policy


def matmul(a: torch.Tensor, b: torch.Tensor,
           policy: Optional[Policy] = None) -> torch.Tensor:
    policy = policy or default_policy()
    out = torch.matmul(a.to(policy.compute_dtype),
                       b.to(policy.compute_dtype))
    return out.to(policy.accum_dtype)


def dense(x, kernel, bias=None, policy: Optional[Policy] = None):
    """Fully-connected transform y = x @ W (+ b)."""
    y = matmul(x, kernel, policy=policy)
    if bias is not None:
        y = y + bias
    return y


def multiplex(index, *inputs):
    """Row-wise select among inputs: out[i] = inputs[index[i]][i]."""
    stacked = torch.stack(inputs)                          # [K, B, ...]
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


def bilinear_tensor_product(x, y, weight, bias=None):
    """out[b, k] = x[b] @ W[k] @ y[b] (+ bias[k]). x [B, M], y [B, N],
    weight [K, M, N] -> [B, K]."""
    out = torch.einsum("bm,kmn,bn->bk", x, weight, y)
    if bias is not None:
        out = out + bias
    return out


def conv_shift(x, y):
    """Circular correlation of each row pair: x [B, M], y [B, N] (N odd,
    N <= M) -> [B, M], out[b, i] = sum_j y[b, j] * x[b, (i + j - N//2)
    mod M], as a gather over a static [M, N] index table and an einsum."""
    m = x.shape[1]
    n = y.shape[1]
    if n % 2 != 1:
        raise ValueError(f"conv_shift kernel width must be odd, got {n}")
    if n > m:
        raise ValueError(f"conv_shift kernel width {n} exceeds row width {m}")
    ar = lambda k: torch.arange(k, device=x.device)
    idx = (ar(m)[:, None] + ar(n)[None, :] - n // 2) % m
    return torch.einsum("bmn,bn->bm", x[:, idx], y)


def dot_prod(a, b):
    """Row-wise dot product: a, b [B, D] -> [B, 1]."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def out_prod(a, b):
    """Row-wise outer product: a [B, M], b [B, N] -> [B, M*N]."""
    return (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1)


def convex_comb(weights, x):
    """weights [B, K], x [B, K*D] -> [B, D] = sum_k weights[b, k] *
    x[b, k*D:(k+1)*D]."""
    b, k = weights.shape
    return torch.einsum("bk,bkd->bd", weights, x.reshape(b, k, -1))


def selective_fc(x, kernel, bias, selected):
    """The fully-connected output at selected columns only: x [B, In],
    kernel [In, Out], selected [B, K] int -> [B, K], out[b, j] = x[b] @
    kernel[:, selected[b, j]] (+ bias[selected[b, j]])."""
    sel = selected.long()
    out = torch.einsum("bi,ibk->bk", x, kernel[:, sel])
    if bias is not None:
        out = out + bias[sel]
    return out
