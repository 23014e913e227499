"""Core layers: Dense, Embedding, Lambda (port of the parts of
`paddle_tpu.nn.layers` the text classifiers use; see `nn.module` for the
layer contract). The other layers come with the image models."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from paddle_tpu_torch.core.dtypes import Policy, default_policy
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.nn.module import Layer, ShapeSpec
from paddle_tpu_torch.ops import linalg

#: the activations a Dense layer takes by name (the ported subset of
#: `paddle_tpu.ops.activations`)
ACTIVATIONS = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
}


def get_activation(name):
    if callable(name):
        return name
    if name is None:
        return ACTIVATIONS["identity"]
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; known: "
                         f"{sorted(ACTIVATIONS)}") from None


class Dense(Layer):
    """Fully-connected layer y = act(x @ W + b), W [in, out]."""

    def __init__(self, features: int, *, activation=None,
                 use_bias: bool = True, kernel_init="smart",
                 bias_init="zeros", name: Optional[str] = None,
                 policy: Optional[Policy] = None):
        self.features = features
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.kernel_init = initializers.get(kernel_init)
        self.bias_init = initializers.get(bias_init)
        self.name = name
        self.policy = policy

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        in_f = spec.shape[-1]
        out_spec = ShapeSpec(spec.shape[:-1] + (self.features,), spec.dtype)
        if _abstract:
            return {}, {}, out_spec
        params = {"kernel": self.kernel_init(rng, (in_f, self.features))}
        if self.use_bias:
            params["bias"] = self.bias_init(rng, (self.features,))
        return params, {}, out_spec

    def _apply(self, params, state, x, *, training: bool, rng):
        y = linalg.dense(x, params["kernel"], params.get("bias"),
                         policy=self.policy or default_policy())
        return self.activation(y), {}


class Embedding(Layer):
    """Embedding lookup table [vocab, features]."""

    def __init__(self, vocab_size: int, features: int, *,
                 embedding_init="normal", name: Optional[str] = None):
        self.vocab_size = vocab_size
        self.features = features
        self.embedding_init = initializers.get(embedding_init)
        self.name = name

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        out_spec = ShapeSpec(spec.shape + (self.features,), torch.float32)
        if _abstract:
            return {}, {}, out_spec
        return ({"table": self.embedding_init(
            rng, (self.vocab_size, self.features))}, {}, out_spec)

    def _apply(self, params, state, ids, *, training: bool, rng):
        return params["table"][ids.long()], {}


class Lambda(Layer):
    """Wrap an arbitrary function as a layer."""

    def __init__(self, fn: Callable, out_spec_fn=None,
                 name: Optional[str] = None):
        self.fn = fn
        self.out_spec_fn = out_spec_fn
        self.name = name

    def _init(self, rng, *specs, _abstract: bool = False):
        out = self.out_spec_fn(*specs) if self.out_spec_fn else specs[0]
        return {}, {}, out

    def _apply(self, params, state, *inputs, training: bool, rng):
        return self.fn(*inputs), {}
