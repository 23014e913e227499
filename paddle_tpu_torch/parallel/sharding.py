"""Parameter and batch sharding rules (port of
`paddle_tpu.parallel.sharding`).

Placement is declarative: first-match (regex, PartitionSpec) rules map
parameter paths (`core.pytree` names, `blocks/0/qkv/kernel`) to specs
over the mesh axes, and `core.mesh.distribute` places each leaf as a
DTensor, whose operators then insert the collectives (JAX: XLA's
partitioner). A spec axis the leaf's dim does not divide is dropped
(that dim replicated), never split unevenly, as in JAX.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from paddle_tpu_torch.core.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                        NamedSharding, P)
from paddle_tpu_torch.core.pytree import tree_map, tree_map_with_name

Rule = Tuple[str, P]


def make_param_shardings(params, mesh: Mesh,
                         rules: Optional[Sequence[Rule]] = None):
    """Map each named param leaf to a NamedSharding via first-match rules.

    Rules are (regex, PartitionSpec); unmatched leaves are replicated. A
    spec axis is silently dropped (replicated) if the leaf dim is not
    divisible by the mesh axis size -- the safe default for odd shapes.
    """
    rules = list(rules or [])

    def to_sharding(name: str, leaf):
        for pattern, spec in rules:
            if re.search(pattern, name):
                return NamedSharding(mesh, _fit_spec(spec, leaf.shape, mesh))
        return NamedSharding(mesh, P())

    return tree_map_with_name(to_sharding, params)


def _fit_spec(spec: P, shape, mesh: Mesh) -> P:
    fitted = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            fitted.append(None)
            continue
        size = 1
        for ax in (axis if isinstance(axis, tuple) else (axis,)):
            size *= mesh.shape[ax]
        fitted.append(axis if shape[i] % size == 0 else None)
    return P(*fitted)


# Ready-made tensor-parallel rules for the layer library: Dense kernels
# shard their output features, Embedding tables their vocab rows.
MEGATRON_RULES: List[Rule] = [
    (r"(attn|qkv|fc1|up|gate).*?/kernel$", P(None, MODEL_AXIS)),
    (r"(proj|fc2|down|out).*?/kernel$", P(MODEL_AXIS, None)),
    (r"/table$", P(MODEL_AXIS, None)),
]


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))


def batch_spec_tree(batch, mesh: Mesh):
    """Shard the leading axis of every batch leaf over the data axis."""
    sh = batch_sharding(mesh)
    return tree_map(lambda _: sh, batch)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def zero_shardings(opt_state, mesh: Mesh):
    """ZeRO-style optimizer-state sharding: slice the largest divisible dim
    of each moment buffer across the data axis (the first dim the axis
    divides, as JAX's)."""
    n_data = mesh.shape[DATA_AXIS]

    def to_sharding(leaf):
        if not hasattr(leaf, "shape") or leaf.ndim == 0:
            return NamedSharding(mesh, P())
        for i, d in enumerate(leaf.shape):
            if d % n_data == 0 and d >= n_data:
                spec = [None] * leaf.ndim
                spec[i] = DATA_AXIS
                return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P())

    return tree_map(to_sharding, opt_state)


def place(tree, shardings):
    """Distribute every leaf of `tree` to its sharding (a tree of the
    same structure) -- JAX's `jax.tree.map(jax.device_put, tree, sh)`."""
    from paddle_tpu_torch.core.mesh import distribute
    from paddle_tpu_torch.core.pytree import tree_map_multi

    return tree_map_multi(lambda x, sh: distribute(x, sh), tree, shardings)
