"""Normalization (mirror of `paddle_tpu.ops.norm.layer_norm`)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtypes import at_least_f32


def layer_norm(x: torch.Tensor, scale, offset, *, epsilon: float = 1e-5,
               axis: int = -1) -> torch.Tensor:
    """Statistics in (at least) f32, output cast back to x's dtype."""
    x32 = at_least_f32(x)
    mean = x32.mean(dim=axis, keepdim=True)
    var = x32.var(dim=axis, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + epsilon)
    return (y * scale + offset).to(x.dtype)
