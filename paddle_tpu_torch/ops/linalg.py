"""Dense linear algebra with dtype policy (mirror of
`paddle_tpu.ops.linalg`). Kernels are stored `[in, out]` and applied as
`x @ W`; the products go to `torch.matmul`, as the JAX package leaves
them to XLA."""

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
