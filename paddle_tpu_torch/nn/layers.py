"""Core layers (port of `paddle_tpu.nn.layers`: Dense, Conv2D, the
pools, BatchNorm, LayerNorm, LRN, Dropout, Embedding, Flatten,
Activation, Lambda; see `nn.module` for the layer contract).

Image layers are NHWC with conv kernels [kh, kw, Cin/groups, Cout], the
JAX package's layout, so parameter and state trees cross the weight
bridge without transposes.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch

from paddle_tpu_torch.core.dtypes import Policy, default_policy
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.nn.module import Layer, ShapeSpec
from paddle_tpu_torch.ops import activations as A
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import norm as norm_ops


#: an activation by name from `ops.activations`' table (ValueError listing
#: the known names otherwise), a callable as it is, or None (identity)
get_activation = A.get


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


class Conv2D(Layer):
    """2-D conv layer, NHWC; kernel [kh, kw, Cin/groups, Cout], msra
    init. space_to_depth=True (stride > 1, groups 1, no dilation)
    computes it through `ops.conv.conv2d_space_to_depth`: the same
    params and output."""

    def __init__(
        self,
        features: int,
        kernel_size: Union[int, Tuple[int, int]] = 3,
        *,
        stride: Union[int, Tuple[int, int]] = 1,
        padding="SAME",
        dilation: Union[int, Tuple[int, int]] = 1,
        groups: int = 1,
        activation=None,
        use_bias: bool = True,
        kernel_init="msra",
        bias_init="zeros",
        name: Optional[str] = None,
        policy: Optional[Policy] = None,
        space_to_depth: bool = False,
    ):
        self.features = features
        self.kernel_size = conv_ops._pair(kernel_size)
        self.stride = conv_ops._pair(stride)
        self.padding = padding
        self.dilation = conv_ops._pair(dilation)
        self.groups = groups
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.kernel_init = initializers.get(kernel_init)
        self.bias_init = initializers.get(bias_init)
        self.name = name
        self.policy = policy
        self.space_to_depth = (
            space_to_depth and groups == 1 and self.dilation == (1, 1)
            and self.stride != (1, 1)
        )

    def _out_hw(self, h, w):
        return conv_ops.out_hw(h, w, self.kernel_size, self.stride,
                               self.padding, self.dilation)

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        n, h, w, c = spec.shape
        if c % self.groups:
            raise ValueError("channels not divisible by groups")
        oh, ow = self._out_hw(h, w)
        out_spec = ShapeSpec((n, oh, ow, self.features), spec.dtype)
        if _abstract:
            return {}, {}, out_spec
        kh, kw = self.kernel_size
        params = {"kernel": self.kernel_init(
            rng, (kh, kw, c // self.groups, self.features))}
        if self.use_bias:
            params["bias"] = self.bias_init(rng, (self.features,))
        return params, {}, out_spec

    def _apply(self, params, state, x, *, training: bool, rng):
        policy = self.policy or default_policy()
        if self.space_to_depth:
            y = conv_ops.conv2d_space_to_depth(
                x, params["kernel"], stride=self.stride,
                padding=self.padding, bias=params.get("bias"),
                policy=policy)
        else:
            y = conv_ops.conv2d(
                x, params["kernel"], stride=self.stride,
                padding=self.padding, dilation=self.dilation,
                groups=self.groups, bias=params.get("bias"), policy=policy)
        # under an nn.Remat(policy="conv_out") ancestor this output (an
        # aten.convolution, plus the bias add) is what the backward keeps
        return self.activation(y), {}


class MaxPool2D(Layer):
    """Max pooling, NHWC. tie_split: see `ops.conv.max_pool2d` (None
    reads PADDLE_TPU_POOL_TIE_SPLIT at apply time)."""

    def __init__(self, window=2, *, stride=None, padding="VALID", name=None,
                 tie_split=None):
        self.window = conv_ops._pair(window)
        self.stride = conv_ops._pair(stride if stride is not None else window)
        self.padding = padding
        self.name = name
        self.tie_split = tie_split

    def _out_hw(self, h, w):
        return conv_ops.out_hw(h, w, self.window, self.stride, self.padding)

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        n, h, w, c = spec.shape
        oh, ow = self._out_hw(h, w)
        return {}, {}, ShapeSpec((n, oh, ow, c), spec.dtype)

    def _apply(self, params, state, x, *, training: bool, rng):
        return (conv_ops.max_pool2d(x, self.window, stride=self.stride,
                                    padding=self.padding,
                                    tie_split=self.tie_split), {})


class AvgPool2D(MaxPool2D):
    def _apply(self, params, state, x, *, training: bool, rng):
        return (conv_ops.avg_pool2d(x, self.window, stride=self.stride,
                                    padding=self.padding), {})


class GlobalAvgPool2D(Layer):
    def __init__(self, name=None):
        self.name = name

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        n, h, w, c = spec.shape
        return {}, {}, ShapeSpec((n, c), spec.dtype)

    def _apply(self, params, state, x, *, training: bool, rng):
        return conv_ops.global_avg_pool2d(x), {}


class BatchNorm(Layer):
    """Batch normalization with running stats as explicit state: params
    scale/offset, state mean/var, all f32 [C]."""

    def __init__(self, *, momentum: float = 0.9, epsilon: float = 1e-5,
                 activation=None, fast_variance: bool = True,
                 name: Optional[str] = None):
        self.momentum = momentum
        self.epsilon = epsilon
        self.activation = get_activation(activation)
        self.fast_variance = fast_variance
        self.name = name

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        c = spec.shape[-1]
        if _abstract:
            return {}, {}, spec
        params = {"scale": torch.ones(c), "offset": torch.zeros(c)}
        state = {"mean": torch.zeros(c), "var": torch.ones(c)}
        return params, state, spec

    def _apply(self, params, state, x, *, training: bool, rng):
        y, new_mean, new_var = norm_ops.batch_norm(
            x, params["scale"], params["offset"], state["mean"],
            state["var"], training=training, momentum=self.momentum,
            epsilon=self.epsilon, fast_variance=self.fast_variance)
        return self.activation(y), {"mean": new_mean, "var": new_var}


class LayerNorm(Layer):
    def __init__(self, *, epsilon: float = 1e-5, name: Optional[str] = None):
        self.epsilon = epsilon
        self.name = name

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        c = spec.shape[-1]
        if _abstract:
            return {}, {}, spec
        return {"scale": torch.ones(c), "offset": torch.zeros(c)}, {}, spec

    def _apply(self, params, state, x, *, training: bool, rng):
        return norm_ops.layer_norm(x, params["scale"], params["offset"],
                                   epsilon=self.epsilon), {}


class LRN(Layer):
    """Cross-map local response normalization (`ops.norm.lrn`)."""

    def __init__(self, size: int = 5, *, alpha: float = 1e-4,
                 beta: float = 0.75, k: float = 1.0,
                 name: Optional[str] = None):
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.name = name

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        return {}, {}, spec

    def _apply(self, params, state, x, *, training: bool, rng):
        return norm_ops.lrn(x, size=self.size, alpha=self.alpha,
                            beta=self.beta, k=self.k), {}


class Dropout(Layer):
    """Inverted dropout: scales by 1/keep at train time; identity at
    eval or at rate 0. The mask is drawn from `rng`, a torch.Generator
    on x's device (a generator on another device raises: the mask is
    never drawn on the host for a card tensor). Its draws never match
    jax.random's."""

    def __init__(self, rate: float = 0.5, name: Optional[str] = None):
        if not 0.0 <= rate < 1.0:
            raise ValueError("dropout rate must be in [0,1)")
        self.rate = rate
        self.name = name

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        return {}, {}, spec

    def _apply(self, params, state, x, *, training: bool, rng):
        if not training or self.rate == 0.0:
            return x, {}
        if not isinstance(rng, torch.Generator):
            raise ValueError("Dropout needs a torch.Generator rng in "
                             "training mode")
        if rng.device.type != x.device.type:
            raise ValueError(f"Dropout's generator is on {rng.device} but "
                             f"its input on {x.device}")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype), {}


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


class Flatten(Layer):
    def __init__(self, name: Optional[str] = None):
        self.name = name

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        flat = math.prod(spec.shape[1:])
        return {}, {}, ShapeSpec((spec.shape[0], flat), spec.dtype)

    def _apply(self, params, state, x, *, training: bool, rng):
        return x.reshape(x.shape[0], -1), {}


class Activation(Layer):
    def __init__(self, fn, name: Optional[str] = None):
        self.fn = get_activation(fn)
        self.name = name

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        return {}, {}, spec

    def _apply(self, params, state, x, *, training: bool, rng):
        return self.fn(x), {}


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
