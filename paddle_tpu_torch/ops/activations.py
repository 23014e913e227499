"""Activation functions (port of `paddle_tpu.ops.activations`: the same
names, defaults and registry, in torch ops). sequence_softmax lives in
ops.sequence (it needs segment ids)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def identity(x):
    return x


linear = identity


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def stanh(x, scale_a: float = 0.67, scale_b: float = 1.7159):
    """Scaled tanh: b * tanh(a * x)."""
    return scale_b * torch.tanh(scale_a * x)


def relu(x):
    return torch.relu(x)


def brelu(x, t_min: float = 0.0, t_max: float = 24.0):
    """Bounded relu: clip to [t_min, t_max]."""
    return torch.clamp(x, t_min, t_max)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def leaky_relu(x, alpha: float = 0.01):
    return torch.where(x >= 0, x, alpha * x)


def elu(x, alpha: float = 1.0):
    return F.elu(x, alpha)


def gelu(x):
    """The tanh approximation (jax.nn.gelu's default)."""
    return F.gelu(x, approximate="tanh")


def softrelu(x, threshold: float = 40.0):
    """log(1 + exp(x)), input clipped to [-t, t]."""
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


def softplus(x):
    """log(1 + exp(x)) as logaddexp(x, 0) (jax.nn.softplus)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def softsign(x):
    return x / (1.0 + torch.abs(x))


def abs_act(x):
    return torch.abs(x)


def square(x):
    return torch.square(x)


def exponential(x):
    return torch.exp(x)


def log_act(x):
    return torch.log(x)


def sqrt_act(x):
    return torch.sqrt(x)


def reciprocal(x):
    return 1.0 / x


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


def swish(x):
    return x * torch.sigmoid(x)


def hard_sigmoid(x, slope: float = 0.2, offset: float = 0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hard_shrink(x, threshold: float = 0.5):
    return torch.where(torch.abs(x) > threshold, x, 0.0)


def soft_shrink(x, lambda_: float = 0.5):
    return torch.sign(x) * torch.clamp(torch.abs(x) - lambda_, min=0.0)


def thresholded_relu(x, threshold: float = 1.0):
    return torch.where(x > threshold, x, 0.0)


def pow_act(x, factor: float = 1.0):
    return torch.pow(x, factor)


_REGISTRY = {
    "identity": identity,
    "linear": identity,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "stanh": stanh,
    "relu": relu,
    "brelu": brelu,
    "relu6": relu6,
    "leaky_relu": leaky_relu,
    "elu": elu,
    "gelu": gelu,
    "softrelu": softrelu,
    "softplus": softplus,
    "softsign": softsign,
    "abs": abs_act,
    "square": square,
    "exponential": exponential,
    "exp": exponential,
    "log": log_act,
    "sqrt": sqrt_act,
    "reciprocal": reciprocal,
    "softmax": softmax,
    "log_softmax": log_softmax,
    "swish": swish,
    "hard_sigmoid": hard_sigmoid,
    "hard_shrink": hard_shrink,
    "soft_shrink": soft_shrink,
    "thresholded_relu": thresholded_relu,
}


def get(name):
    """Look up an activation by name; a callable passes through, None is
    identity. An unknown name raises ValueError listing the known ones."""
    if callable(name):
        return name
    if name is None:
        return identity
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def prelu(x, alpha):
    """Parametric ReLU: y = x if x > 0 else alpha * x, alpha a learned
    per-channel [C] (or scalar) parameter broadcast over x."""
    return torch.where(x > 0, x, alpha * x)
