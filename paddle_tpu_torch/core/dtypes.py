"""Dtype policy: parameters, compute, and output dtypes.

Mirror of `paddle_tpu.core.dtypes` with torch dtypes. The default policy
computes in float32 (the JAX package's default); `bf16_compute_policy`
keeps float32 parameters and computes in bfloat16.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtype policy applied by layers.

    param_dtype:   dtype parameters are stored in (master weights).
    compute_dtype: dtype inputs/weights are cast to before matmuls.
    accum_dtype:   dtype of matmul outputs (kept equal to compute_dtype).
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32


_DEFAULT = Policy()


def default_policy() -> Policy:
    return _DEFAULT


def set_default_policy(policy: Policy) -> None:
    global _DEFAULT
    _DEFAULT = policy


def bf16_compute_policy() -> Policy:
    """f32 parameters, bf16 compute; reductions that need f32 upcast
    explicitly via at_least_f32."""
    return Policy(param_dtype=torch.float32,
                  compute_dtype=torch.bfloat16,
                  accum_dtype=torch.bfloat16)


def sqrt_in(dtype: torch.dtype, n: int) -> float:
    """sqrt(n) computed and rounded in `dtype`, as a Python float: the
    attention scale `sqrt(asarray(dh, dtype))` of the JAX package,
    without a device scalar (dividing a tensor by it gives the same
    values as dividing by the 0-d tensor)."""
    return float(torch.sqrt(torch.tensor(float(n), dtype=dtype)))


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast to float32 for stable reductions, keeping float64 intact."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
