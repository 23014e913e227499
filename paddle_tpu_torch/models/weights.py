"""Weight bridge between the JAX package's parameter pytree and the
port's parameters.

Both sides use the same tree (nested dicts and lists) and the same
layouts -- dense kernels `[in, out]`, embedding tables `[vocab, dim]` --
so the bridge converts leaves and never transposes. The JAX side hands
its tree over as numpy arrays (`jax.device_get(params)`); nothing here
imports JAX. A weight-only int8 leaf (the JAX `QuantizedTensor`, or any
`(q, scale)` namedtuple with those fields) crosses as a
`serve.quant.QuantizedTensor` of an int8 `q` and an f32 `scale`.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.serve.quant import QuantizedTensor
from paddle_tpu_torch.train.state import TrainState


def _is_quantized(leaf) -> bool:
    return getattr(leaf, "_fields", None) == ("q", "scale")


def params_from_numpy(tree, *, device=None, dtype=torch.float32):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors on
    `device` (None -> cuda). Floating leaves are cast to `dtype`; integer
    leaves keep their type; quantized leaves keep int8 data and f32
    scales."""
    dev = resolve_device(device)

    def leaf(a):
        if _is_quantized(a):
            return QuantizedTensor(
                torch.from_numpy(np.array(a.q, np.int8)).to(dev),
                torch.from_numpy(np.array(a.scale, np.float32)).to(dev))
        t = torch.from_numpy(np.array(a))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """The port's parameter tree -> nested dicts/lists of numpy arrays
    (bf16 leaves come back as float32, which numpy can hold; quantized
    leaves as QuantizedTensor(q, scale) pairs of numpy arrays). A sharded
    leaf (a DTensor) is gathered first, so a checkpoint written from a
    sharded run is the unsharded one; every rank of its mesh calls this
    then."""

    def arr(t):
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def leaf(t):
        if isinstance(t, QuantizedTensor):
            return QuantizedTensor(arr(t.q), arr(t.scale))
        return arr(t)

    return tree_map(leaf, tree)


def _keep_containers(fn, tree):
    """fn over the leaves; dicts, lists and tuples (an optimizer's empty
    `()` state above all) keep their types, as JAX's tree does."""
    if isinstance(tree, dict):
        return {k: _keep_containers(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_quantized(tree):
        return type(tree)(_keep_containers(fn, v) for v in tree)
    return fn(tree)


def opt_state_from_numpy(opt_state, *, device=None):
    """An optimizer state with numpy leaves (the JAX optimizer's
    `opt_state` after `jax.device_get`) -> the port's optimizer's state on
    `device` (None -> cuda), in the same tree: every optimizer of
    `optim.optimizers` keeps JAX's layout (momentum's `velocity`, adam's
    `m`/`v`, adamax's `m`/`u`, ftrl's `n`/`z`, the L-BFGS flat `s`, `y`,
    `rho`, `prev_x`, `prev_g`, `gamma` and int32 `count`; `()` for sgd
    and proximal_gd). Float leaves become f32, integer leaves keep their
    type."""
    dev = resolve_device(device)
    return _keep_containers(
        lambda a: params_from_numpy(a, device=dev), opt_state)


def opt_state_to_numpy(opt_state):
    """The port's optimizer state -> the same tree of numpy arrays, the
    JAX optimizer's `opt_state` layout (tuples stay tuples)."""
    return _keep_containers(params_to_numpy, opt_state)


def train_state_from_numpy(state, *, device=None):
    """A training state with numpy leaves -- the JAX package's TrainState
    after `jax.device_get`, or any object with its four fields -> the
    port's `train.state.TrainState` on `device` (None -> cuda): params,
    model_state and opt_state (adam's `m`/`v`, momentum's `velocity`)
    through params_from_numpy (opt_state through opt_state_from_numpy, so
    every optimizer's state crosses), step as an int32 0-d tensor."""
    conv = lambda tree: params_from_numpy(tree, device=device)
    return TrainState(params=conv(state.params),
                      model_state=conv(state.model_state),
                      opt_state=opt_state_from_numpy(state.opt_state,
                                                     device=device),
                      step=conv(np.asarray(state.step, np.int32)))


def train_state_to_numpy(state):
    """The port's TrainState -> the same four fields with numpy leaves
    (a TrainState of numpy trees; the JAX side rebuilds its own TrainState
    from the fields)."""
    return type(state)(params=params_to_numpy(state.params),
                       model_state=params_to_numpy(state.model_state),
                       opt_state=opt_state_to_numpy(state.opt_state),
                       step=params_to_numpy(state.step))
