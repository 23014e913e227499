"""Weight bridge between the JAX package's parameter pytree and the
port's parameters.

Both sides use the same tree (nested dicts and lists) and the same
layouts -- dense kernels `[in, out]`, embedding tables `[vocab, dim]` --
so the bridge converts leaves and never transposes. The JAX side hands
its tree over as numpy arrays (`jax.device_get(params)`); nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.devices import resolve_device


def params_from_numpy(tree, *, device=None, dtype=torch.float32):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors on
    `device` (None -> cuda). Floating leaves are cast to `dtype`; integer
    leaves keep their type."""
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """The port's parameter tree -> nested dicts/lists of numpy arrays
    (bf16 leaves come back as float32, which numpy can hold)."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, tree)


def tree_map(fn, tree):
    """Apply fn to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
