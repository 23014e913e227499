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
    leaves as QuantizedTensor(q, scale) pairs of numpy arrays)."""

    def arr(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def leaf(t):
        if isinstance(t, QuantizedTensor):
            return QuantizedTensor(arr(t.q), arr(t.scale))
        return arr(t)

    return tree_map(leaf, tree)
