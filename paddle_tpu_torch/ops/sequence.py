"""Dense padded sequence ops (port of `length_mask` and
`dense_sequence_pool` of `paddle_tpu.ops.sequence`; the packed
segment ops come with the models that use them)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def length_mask(lengths, max_len: int):
    """[B, T] boolean mask from lengths."""
    return torch.arange(max_len, device=lengths.device)[None, :] < \
        lengths[:, None]


def dense_sequence_pool(x, lengths, mode: str = "mean"):
    """Pool a padded dense [B, T, F] batch per sequence. "max" reduces
    with `torch.amax`, which splits a tie's gradient evenly among the
    tied entries, as `jnp.max` does."""
    t = x.shape[1]
    mask = length_mask(lengths, t)
    maskf = mask.to(x.dtype)[..., None]
    if mode == "sum":
        return torch.sum(x * maskf, dim=1)
    if mode == "mean":
        denom = torch.clamp(lengths.to(x.dtype), min=1)[:, None]
        return torch.sum(x * maskf, dim=1) / denom
    if mode == "sqrt":
        denom = torch.sqrt(torch.clamp(lengths.to(x.dtype), min=1))[:, None]
        return torch.sum(x * maskf, dim=1) / denom
    if mode == "max":
        neg = torch.where(mask[..., None], x, NEG_INF)
        out = torch.amax(neg, dim=1)
        return torch.where(out <= NEG_INF / 2, 0.0, out)
    nonempty = (lengths > 0).to(x.dtype)[:, None]
    if mode == "last":
        idx = torch.clamp(lengths.long() - 1, 0, t - 1)
        return torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0] * \
            nonempty
    if mode == "first":
        # zero-length rows return 0, consistent with sum/mean/max
        return x[:, 0] * nonempty
    raise ValueError(f"unknown pool mode {mode!r}")
