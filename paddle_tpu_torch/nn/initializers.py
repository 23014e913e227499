"""Weight initializers (mirror of the `paddle_tpu.nn.initializers`
schemes, with the same fans and distributions).

An initializer is called as `init(rng, shape)` where `rng` is a numpy
`RandomState` or a CPU `torch.Generator`; it returns a float32 CPU
tensor (callers move it to their device). The draws differ from
`jax.random`'s, so tests that compare with the JAX package carry
weights across with `models.weights.params_from_numpy` instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def as_rng(rng):
    """An int seed becomes a numpy RandomState; a RandomState or a CPU
    torch.Generator passes through."""
    if isinstance(rng, (int, np.integer)):
        return np.random.RandomState(int(rng))
    return rng


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def uniform_between(rng, shape, low, high):
    """float32 CPU tensor drawn uniformly from [low, high)."""
    if isinstance(rng, np.random.RandomState):
        return torch.from_numpy(
            rng.uniform(low, high, size=shape).astype(np.float32))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        low, high, generator=rng)


def _standard_normal(rng, shape):
    if isinstance(rng, np.random.RandomState):
        return torch.from_numpy(
            rng.standard_normal(size=shape).astype(np.float32))
    return torch.randn(shape, dtype=torch.float32, generator=rng)


def constant(value: float = 0.0):
    def init(rng, shape):
        return torch.full(tuple(shape), value, dtype=torch.float32)

    return init


zeros = constant(0.0)
ones = constant(1.0)


def uniform(scale: float = 1.0):
    def init(rng, shape):
        return uniform_between(rng, tuple(shape), -scale, scale)

    return init


def normal(std: float = 0.01, mean: float = 0.0):
    def init(rng, shape):
        return mean + std * _standard_normal(rng, tuple(shape))

    return init


def xavier_uniform():
    """Glorot uniform: uniform(+-sqrt(6 / (fan_in + fan_out)))."""

    def init(rng, shape):
        fan_in, fan_out = _fans(tuple(shape))
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return uniform_between(rng, tuple(shape), -limit, limit)

    return init


def xavier_normal():
    """Glorot normal: std sqrt(2 / (fan_in + fan_out))."""

    def init(rng, shape):
        fan_in, fan_out = _fans(tuple(shape))
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return std * _standard_normal(rng, tuple(shape))

    return init


def msra():
    """He/Kaiming normal: std sqrt(2 / fan_in) (fan_in of a conv kernel
    [kh, kw, in, out] is kh * kw * in)."""

    def init(rng, shape):
        fan_in, _ = _fans(tuple(shape))
        std = math.sqrt(2.0 / fan_in)
        return std * _standard_normal(rng, tuple(shape))

    return init


def smart_uniform():
    """The reference's 'initial_smart': uniform(+-1/sqrt(fan_in))."""

    def init(rng, shape):
        fan_in, _ = _fans(tuple(shape))
        limit = 1.0 / math.sqrt(fan_in)
        return uniform_between(rng, tuple(shape), -limit, limit)

    return init


def get(name_or_fn):
    """An initializer by name (the JAX package's table), or a callable as
    it is."""
    if callable(name_or_fn):
        return name_or_fn
    table = {
        "zeros": zeros,
        "ones": ones,
        "xavier": xavier_uniform(),
        "xavier_normal": xavier_normal(),
        "msra": msra(),
        "smart": smart_uniform(),
        "normal": normal(),
        "uniform": uniform(),
    }
    try:
        return table[name_or_fn]
    except KeyError:
        raise ValueError(f"unknown initializer {name_or_fn!r}; known: "
                         f"{sorted(table)}") from None
