"""Normalization (port of `paddle_tpu.ops.norm`): batch_norm, layer_norm,
lrn, cross_channel_norm and l2_normalize."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import at_least_f32


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode batch norm over every axis but the last.

    Forward: batch mean and biased variance in (at least) f32, y = (x -
    mean) * rsqrt(var + eps) * scale + offset computed in f32 and cast to
    x's dtype. Saves x (in its own dtype), the per-channel mean and
    inverse std and the scale -- not the f32 intermediates an eager
    formula under autograd would keep, several times the activation's
    size at ResNet-50's batch 256. Backward: the standard gradient
    dx = scale * rstd * (g - mean(g) - xhat * mean(g * xhat)), dscale =
    sum(g * xhat), doffset = sum(g), in f32. Returns (y, mean, var);
    mean and var carry no gradient (they feed only the running stats)."""

    @staticmethod
    def forward(ctx, x, scale, offset, epsilon, fast_variance):
        dims = tuple(range(x.ndim - 1))
        x32 = at_least_f32(x)
        mean = x32.mean(dim=dims)
        if fast_variance:
            var = torch.clamp(x32.square().mean(dim=dims) - mean.square(),
                              min=0.0)
        else:
            var = x32.var(dim=dims, unbiased=False)
        rstd = torch.rsqrt(var + epsilon)
        y = ((x32 - mean) * (rstd * scale) + offset).to(x.dtype)
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, scale = ctx.saved_tensors
        dims = tuple(range(x.ndim - 1))
        n = x.numel() // x.shape[-1]
        g = at_least_f32(dy)
        xhat = (at_least_f32(x) - mean) * rstd
        sum_g = g.sum(dim=dims)
        sum_gx = (g * xhat).sum(dim=dims)
        dx = (g - sum_g / n - xhat * (sum_gx / n)) * (scale * rstd)
        return (dx.to(x.dtype), sum_gx.to(scale.dtype), sum_g.to(scale.dtype),
                None, None)


def batch_norm(
    x,
    scale,
    offset,
    running_mean,
    running_var,
    *,
    training: bool,
    momentum: float = 0.9,
    epsilon: float = 1e-5,
    fast_variance: bool = True,
):
    """Batch norm over all axes but the last (channel) axis.

    Returns (y, new_running_mean, new_running_var). In eval mode the
    running stats pass through unchanged. In training mode the running
    stats follow the JAX package's convention, new = momentum * running
    + (1 - momentum) * batch, with the biased batch variance (torch's
    own `F.batch_norm` uses the opposite momentum and the unbiased
    variance, so it is not used).

    fast_variance=True computes var as max(E[x^2] - E[x]^2, 0) in f32;
    False the centered formula. Training runs `_BatchNormTrain`, one code
    path on the CPU and the card: torch ops only, saving x and two
    per-channel vectors for the backward."""
    if training:
        y, mean, var = _BatchNormTrain.apply(x, scale, offset, epsilon,
                                             fast_variance)
        new_mean = momentum * running_mean + (1.0 - momentum) * mean
        new_var = momentum * running_var + (1.0 - momentum) * var
        return y, new_mean, new_var
    inv = torch.rsqrt(running_var + epsilon) * scale
    y = (x - running_mean) * inv + offset
    return y.to(x.dtype), running_mean, running_var


def layer_norm(x: torch.Tensor, scale, offset, *, epsilon: float = 1e-5,
               axis: int = -1) -> torch.Tensor:
    """Statistics in (at least) f32, output cast back to x's dtype."""
    x32 = at_least_f32(x)
    mean = x32.mean(dim=axis, keepdim=True)
    var = x32.var(dim=axis, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + epsilon)
    return (y * scale + offset).to(x.dtype)


def lrn(x, *, size: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 1.0):
    """Local response normalization across channels (NHWC):
    y = x * (k + alpha * sum_window x^2)^(-beta), the window `size`
    channels wide, padded (size // 2, size - 1 - size // 2). alpha is not
    divided by size (torch's `F.local_response_norm` divides it, and
    works on NCHW, so it is not used). The window sum is one strided
    view of the padded squares (`unfold`) summed over its last axis."""
    half = size // 2
    sq = F.pad(torch.square(x), (half, size - 1 - half))
    window = sq.unfold(-1, size, 1).sum(dim=-1)
    return x * torch.pow(k + alpha * window, -beta)


def cross_channel_norm(x, scale, *, epsilon: float = 1e-10):
    """L2-normalize across the channels (last axis), then scale per
    channel (the SSD norm layer)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True)
                      + epsilon)
    return x / norm * scale


def l2_normalize(x, axis: int = -1, epsilon: float = 1e-12):
    """x / sqrt(sum(x^2) + epsilon) along `axis`."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                      + epsilon)
    return x / norm
