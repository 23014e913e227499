"""Small structural and elementwise ops closing the reference's layer
list (port of `paddle_tpu.ops.misc`): power, slope_intercept,
sum_to_one_norm, switch_order, trans, resize, maxid, sampling_id,
scale_shift, scale_sub_region, data_norm, row_conv.

Each is a plain function on tensors of any device. `maxid` takes its
top ids from a stable descending sort, so tied values keep the lower
index first, as `jax.lax.top_k` does (`torch.topk` promises no tie
order on CUDA). `sampling_id` is the Gumbel-max draw of
`jax.random.categorical`; its Gumbel noise is injectable (`noise=`).
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.ops.sampling import gumbel_noise


def power(x, p):
    """y[b, ...] = x[b, ...] ** p[b] (a per-sample exponent, [B] or
    [B, 1])."""
    return torch.pow(x, p.reshape(p.shape[0], *([1] * (x.ndim - 1))))


def slope_intercept(x, slope: float = 1.0, intercept: float = 0.0):
    """y = slope * x + intercept."""
    return x * slope + intercept


def sum_to_one_norm(x, *, epsilon: float = 1e-12):
    """Each row divided by its sum (by 1 where |sum| < epsilon)."""
    s = torch.sum(x, dim=-1, keepdim=True)
    return x / torch.where(torch.abs(s) < epsilon, torch.ones_like(s), s)


def switch_order(x, perm=(0, 3, 1, 2), reshape=None):
    """Permute the dims (NHWC <-> NCHW), then optionally reshape."""
    y = x.permute(*perm)
    if reshape is not None:
        y = y.reshape(reshape)
    return y


def trans(x):
    """Swap the last two dims."""
    if x.ndim < 2:
        raise ValueError("trans expects >= 2 dims")
    return torch.swapaxes(x, -1, -2)


def resize(x, size: int):
    """Rows of width `size`; the batch dim absorbs the rest."""
    return x.reshape(-1, size)


def maxid(x, *, beam: int = 1):
    """The top-`beam` (ids, values) of each row; beam 1 gives [B] each.
    Ties keep the lower id first."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    vals, ids = vals[..., :beam], ids[..., :beam]
    return (ids[:, 0], vals[:, 0]) if beam == 1 else (ids, vals)


def sampling_id(generator: Optional[torch.Generator], probs, *,
                noise: Optional[torch.Tensor] = None):
    """One id per row drawn from the distribution `probs` [B, V]:
    argmax(log(max(probs, 1e-30)) + g) with g standard Gumbel draws,
    injected as `noise` [B, V] or drawn from `generator`."""
    logits = torch.log(torch.clamp(probs, min=1e-30))
    if noise is None:
        noise = gumbel_noise(logits.shape, generator=generator,
                             device=logits.device, dtype=logits.dtype)
    return torch.argmax(logits + noise.to(logits.dtype), dim=-1)


def scale_shift(x, scale, shift=None):
    """y = scale * x (+ shift), with learned scalars."""
    y = x * scale
    if shift is not None:
        y = y + shift
    return y


def scale_sub_region(x, boxes, value: float):
    """Scale a per-sample box of an NHWC map by `value`. x [N, H, W, C];
    boxes [N, 6] int, 1-based inclusive (c_start, c_end, h_start, h_end,
    w_start, w_end). The box becomes three arange masks."""
    n, h, w, c = x.shape
    b = boxes.long()

    def rng_mask(lo, hi, size):
        r = torch.arange(size, device=b.device)
        return (r[None, :] >= lo[:, None]) & (r[None, :] <= hi[:, None])

    mask = (rng_mask(b[:, 2] - 1, b[:, 3] - 1, h)[:, :, None, None]
            & rng_mask(b[:, 4] - 1, b[:, 5] - 1, w)[:, None, :, None]
            & rng_mask(b[:, 0] - 1, b[:, 1] - 1, c)[:, None, None, :])
    return torch.where(mask, x * value, x)


def data_norm(x, stats, *, mode: str = "z-score"):
    """Normalize features by dataset statistics computed beforehand:
    stats {"mean", "std", "min", "max", "decimal_scale"} [D] (the keys
    the mode needs); mode "z-score", "min-max" or "decimal-scaling"."""
    if mode == "z-score":
        return (x - stats["mean"]) / torch.clamp(stats["std"], min=1e-12)
    if mode == "min-max":
        span = torch.clamp(stats["max"] - stats["min"], min=1e-12)
        return (x - stats["min"]) / span
    if mode == "decimal-scaling":
        return x / stats["decimal_scale"]
    raise ValueError(f"unknown data_norm mode: {mode!r}")


def row_conv(x, weight, lengths=None):
    """Lookahead convolution over time: y[b, t] = sum_{i < ctx} w[i] *
    x[b, t + i], frames past the sequence's end counting as zero. x
    [B, T, D], weight [ctx, D], lengths [B] optional."""
    bsz, t, d = x.shape
    if lengths is not None:
        tmask = torch.arange(t, device=x.device)[None, :] < \
            lengths.to(x.device)[:, None]
        x = x * tmask[..., None]
    out = torch.zeros_like(x)
    for i in range(weight.shape[0]):
        shifted = torch.cat([x[:, i:, :], x.new_zeros((bsz, i, d))], dim=1)
        out = out + shifted * weight[i]
    return out
