"""Parameter-tree utilities (the port's copy of the parts of
`paddle_tpu.core.pytree` it needs).

Parameters are nested dicts and lists of tensors. A leaf's name is its
path joined with "/" -- dict keys as they are, list positions as
integers -- so `blocks/0/qkv/kernel` names the same leaf on both sides,
and name-matched rules (`serve.quant.DEFAULT_MATCH`) select the same
leaves.

A namedtuple (a `serve.quant.QuantizedTensor`) is one leaf, not a node:
these functions map over tensors and their int8 stand-ins alike.
"""

from __future__ import annotations

from typing import Any, Callable, List


def _is_node(x) -> bool:
    if isinstance(x, dict):
        return True
    return isinstance(x, (list, tuple)) and not hasattr(x, "_fields")


def _path_str(path, sep: str = "/") -> str:
    return sep.join(str(p) for p in path)


def tree_map_with_name(fn: Callable[[str, Any], Any], tree, sep: str = "/"):
    """Map over leaves with their path names: fn(name, leaf) -> new
    leaf. Dicts stay dicts; lists and tuples come back as lists."""

    def go(t, path):
        if isinstance(t, dict):
            return {k: go(v, path + (k,)) for k, v in t.items()}
        if _is_node(t):
            return [go(v, path + (i,)) for i, v in enumerate(t)]
        return fn(_path_str(path, sep), t)

    return go(tree, ())


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply fn to every leaf."""
    return tree_map_with_name(lambda _, leaf: fn(leaf), tree)


def tree_leaves(tree) -> List[Any]:
    """Every leaf, in traversal order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out
