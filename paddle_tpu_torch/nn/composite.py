"""Composite layers: residual blocks, parallel branches, several
networks side by side, and rematerialization (port of
`paddle_tpu.nn.composite`). The parameter and state trees are the JAX
package's."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from paddle_tpu_torch.nn.module import Layer, ShapeSpec
from paddle_tpu_torch.ops import activations as A


class Residual(Layer):
    """y = act(main(x) + shortcut(x)); no shortcut layer means x itself."""

    def __init__(self, main: Layer, shortcut: Optional[Layer] = None, *,
                 activation=None, name: Optional[str] = None):
        self.main = main
        self.shortcut = shortcut
        self.activation = A.get(activation)
        self.name = name

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        params, state = {}, {}
        m_p, m_s, out = self.main._init(rng, spec, _abstract=_abstract)
        if self.shortcut is not None:
            s_p, s_s, _ = self.shortcut._init(rng, spec, _abstract=_abstract)
        if _abstract:
            return {}, {}, out
        params["main"] = m_p
        if m_s:
            state["main"] = m_s
        if self.shortcut is not None:
            if s_p:
                params["shortcut"] = s_p
            if s_s:
                state["shortcut"] = s_s
        return params, state, out

    def _apply(self, params, state, x, *, training: bool, rng):
        y, m_s = self.main._apply(params.get("main", {}),
                                  state.get("main", {}), x,
                                  training=training, rng=rng)
        if self.shortcut is not None:
            sc, s_s = self.shortcut._apply(params.get("shortcut", {}),
                                           state.get("shortcut", {}), x,
                                           training=training, rng=rng)
        else:
            sc, s_s = x, {}
        new_state = {}
        if m_s:
            new_state["main"] = m_s
        if s_s:
            new_state["shortcut"] = s_s
        return self.activation(y + sc), new_state


def _save_conv_outputs(ctx, op, *args, **kwargs):
    # a Conv2D's product is one aten.convolution; everything else in the
    # block (BN's statistics and normalize, activations, adds, pads)
    # recomputes in the backward from the saved conv outputs
    if op == torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _conv_out_contexts():
    return create_selective_checkpoint_contexts(_save_conv_outputs)


class Remat(Layer):
    """Rematerialize a sub-layer's forward during the backward
    (`torch.utils.checkpoint`, non-reentrant).

    policy:
      None        -- save nothing inside the block: the backward re-runs
                     the whole forward from the block input.
      "conv_out"  -- save only the outputs of aten.convolution (every
                     Conv2D's product, selective checkpointing); BN,
                     activations and adds recompute from those.

    The wrapper adopts the inner layer's name and passes params and state
    through, so wrapping does not change a model's trees. The new state
    (BN's running stats) comes from the forward; the recompute's copy is
    dropped, so stats are updated once per step. A `torch.Generator` rng
    is replayed: the recompute starts from the generator state the
    forward started from (so a Dropout draws the forward's mask) and
    leaves the generator where the forward left it."""

    def __init__(self, inner: Layer, *, policy: Optional[str] = "conv_out",
                 name: Optional[str] = None):
        if policy not in (None, "conv_out"):
            raise ValueError(
                f"Remat policy must be None or 'conv_out', got {policy!r}")
        self.inner = inner
        self.policy = policy
        self.name = name if name is not None else inner.name

    def _init(self, rng, *specs, _abstract: bool = False):
        return self.inner._init(rng, *specs, _abstract=_abstract)

    def _apply(self, params, state, *inputs, training: bool, rng):
        gen = rng if isinstance(rng, torch.Generator) else None
        start = []

        def fn(params, state, *inputs):
            after = None
            if gen is not None and start:  # the recompute
                after = gen.get_state()
                gen.set_state(start[0])
            elif gen is not None:
                start.append(gen.get_state())
            try:
                return self.inner._apply(params, state, *inputs,
                                         training=training, rng=rng)
            finally:
                if after is not None:
                    gen.set_state(after)

        if not torch.is_grad_enabled():
            return fn(params, state, *inputs)
        kwargs = {}
        if self.policy == "conv_out":
            kwargs["context_fn"] = _conv_out_contexts
        return checkpoint(fn, params, state, *inputs, use_reentrant=False,
                          **kwargs)


class MultiTask(Layer):
    """Several independent sub-networks trained jointly: init takes one
    ShapeSpec per sub-network (in order), apply one input per
    sub-network and returns a tuple of outputs."""

    def __init__(self, networks, name=None):
        """networks: list of (name, Layer) pairs or a dict."""
        if isinstance(networks, dict):
            networks = list(networks.items())
        self.networks = list(networks)
        self.name = name

    def _check(self, n, what):
        if n != len(self.networks):
            raise ValueError(
                f"{len(self.networks)} sub-networks but {n} {what}")

    def _init(self, rng, *specs, _abstract: bool = False):
        self._check(len(specs), "specs")
        params, state, outs = {}, {}, []
        for (key, net), spec in zip(self.networks, specs):
            sub_p, sub_s, out = net._init(rng, spec, _abstract=_abstract)
            if sub_p:
                params[key] = sub_p
            if sub_s:
                state[key] = sub_s
            outs.append(out)
        return params, state, tuple(outs)

    def _apply(self, params, state, *inputs, training: bool, rng):
        self._check(len(inputs), "inputs")
        outs, new_state = [], {}
        for (key, net), x in zip(self.networks, inputs):
            out, sub_s = net._apply(params.get(key, {}), state.get(key, {}),
                                    x, training=training, rng=rng)
            if sub_s:
                new_state[key] = sub_s
            outs.append(out)
        return tuple(outs), new_state


class Branches(Layer):
    """Apply N sub-layers to the same input and concatenate their
    outputs on the channel (last) axis -- the inception pattern."""

    def __init__(self, branches: Sequence[Layer], name: Optional[str] = None):
        self.branches = list(branches)
        self.name = name

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        params, state = {}, {}
        out_specs: List[ShapeSpec] = []
        for i, br in enumerate(self.branches):
            key = br.name or f"branch{i}"
            b_p, b_s, out = br._init(rng, spec, _abstract=_abstract)
            if b_p:
                params[key] = b_p
            if b_s:
                state[key] = b_s
            out_specs.append(out)
        ch = sum(s.shape[-1] for s in out_specs)
        out_spec = ShapeSpec(out_specs[0].shape[:-1] + (ch,),
                             out_specs[0].dtype)
        return params, state, out_spec

    def _apply(self, params, state, x, *, training: bool, rng):
        outs, new_state = [], {}
        for i, br in enumerate(self.branches):
            key = br.name or f"branch{i}"
            y, b_s = br._apply(params.get(key, {}), state.get(key, {}), x,
                               training=training, rng=rng)
            if b_s:
                new_state[key] = b_s
            outs.append(y)
        return torch.cat(outs, dim=-1), new_state
