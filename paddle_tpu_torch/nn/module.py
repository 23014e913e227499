"""Light module system: layers as config objects + init/apply (port of
`paddle_tpu.nn.module`).

A Layer is a configuration object with two methods --
``init(rng, *specs, device=None) -> (params, state)`` and
``apply(params, state, *inputs, training=..., rng=...) -> (out,
new_state)``. Parameters and mutable statistics are plain nested-dict
trees of tensors that the caller owns, the same trees as the JAX
package's, so the trainer, `train.state.TrainState` and the weight
bridge all work over them.

Randomness: `init` takes an int seed, a numpy RandomState or a CPU
`torch.Generator`, and the layers draw from it in order (the JAX
package splits keys instead, so the draws differ). Parameters are drawn
on the CPU and moved to `device` (None -> cuda, which raises without a
card).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.nn.initializers import as_rng

Params = Dict[str, Any]
State = Dict[str, Any]


class ShapeSpec:
    """Shape+dtype spec used for shape inference during init."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype=torch.float32):
        self.shape = tuple(shape)
        self.dtype = dtype

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return f"ShapeSpec({self.shape}, {self.dtype})"


def spec_of(x) -> ShapeSpec:
    if isinstance(x, ShapeSpec):
        return x
    return ShapeSpec(x.shape, x.dtype)


class Layer:
    """Base class: stateless config; params/state live outside.

    Subclasses implement:
      _init(rng, *specs) -> (params, state, out_specs)
      _apply(params, state, *inputs, training, rng) -> (out, new_state)
    """

    name: Optional[str] = None

    # ---- public API -------------------------------------------------
    def init(self, rng, *specs, device=None) -> Tuple[Params, State]:
        dev = resolve_device(device)
        specs = tuple(spec_of(s) for s in specs)
        params, state, _ = self._init(as_rng(rng), *specs)
        move = lambda t: t.to(dev)
        return tree_map(move, params), tree_map(move, state)

    def out_spec(self, *specs):
        """Shape inference without allocating parameters."""
        specs = tuple(spec_of(s) for s in specs)
        _, _, out = self._init(None, *specs, _abstract=True)
        return out

    def apply(self, params, state, *inputs, training: bool = False,
              rng=None):
        return self._apply(params, state, *inputs, training=training,
                           rng=rng)

    def __call__(self, params, state, *inputs, training: bool = False,
                 rng=None):
        return self.apply(params, state, *inputs, training=training, rng=rng)

    # ---- to implement ----------------------------------------------
    def _init(self, rng, *specs, _abstract: bool = False):
        raise NotImplementedError

    def _apply(self, params, state, *inputs, training: bool, rng):
        raise NotImplementedError


class Sequential(Layer):
    """Compose layers in order; sub-trees are keyed by layer name (or
    `layer{i}`)."""

    def __init__(self, layers: Sequence[Layer], name: Optional[str] = None):
        self.layers = list(layers)
        self.name = name

    def _init(self, rng, *specs, _abstract: bool = False):
        params: Params = {}
        state: State = {}
        cur = specs
        for i, layer in enumerate(self.layers):
            key = layer.name or f"layer{i}"
            if key in params:
                raise ValueError(f"duplicate layer name {key}")
            sub_p, sub_s, cur = layer._init(rng, *cur, _abstract=_abstract)
            if sub_p:
                params[key] = sub_p
            if sub_s:
                state[key] = sub_s
            if not isinstance(cur, tuple):
                cur = (cur,)
        out = cur if len(cur) != 1 else cur[0]
        return params, state, out

    def _apply(self, params, state, *inputs, training: bool, rng):
        cur = inputs
        new_state: State = {}
        for i, layer in enumerate(self.layers):
            key = layer.name or f"layer{i}"
            out, sub_state = layer._apply(
                params.get(key, {}), state.get(key, {}), *cur,
                training=training, rng=rng)
            if sub_state:
                new_state[key] = sub_state
            cur = out if isinstance(out, tuple) else (out,)
        out = cur if len(cur) != 1 else cur[0]
        return out, new_state


def merge_state(old: State, new: State) -> State:
    """Overlay updated sub-states onto the full state tree."""
    merged = dict(old)
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(merged.get(k), dict):
            merged[k] = merge_state(merged[k], v)
        else:
            merged[k] = v
    return merged
