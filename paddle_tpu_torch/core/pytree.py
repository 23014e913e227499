"""Parameter-tree utilities (the port's copy of the parts of
`paddle_tpu.core.pytree` it needs).

Parameters are nested dicts and lists of tensors. A leaf's name is its
path joined with "/" -- dict keys as they are, list positions as
integers -- so `blocks/0/qkv/kernel` names the same leaf on both sides,
and name-matched rules (`serve.quant.DEFAULT_MATCH`) select the same
leaves.

A namedtuple (a `serve.quant.QuantizedTensor`) is one leaf, not a node:
these functions map over tensors and their int8 stand-ins alike.
`flatten_with_keys`/`unflatten_like` walk a tree as JAX flattens it
(dict keys sorted, namedtuples as nodes) and name each leaf as
`jax.tree_util.keystr` does: the order of the parameters tar, the
checkpoints and the L-BFGS flat state.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


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


def tree_map_multi(fn: Callable[..., Any], tree, *others):
    """fn(leaf, *other leaves) over trees of one structure, matched by
    dict key and list position (not by a dict's insertion order); the
    result has `tree`'s structure."""

    def go(t, os):
        if isinstance(t, dict):
            return {k: go(v, [o[k] for o in os]) for k, v in t.items()}
        if _is_node(t):
            return [go(v, [o[i] for o in os]) for i, v in enumerate(t)]
        return fn(t, *os)

    return go(tree, others)


def tree_zip(tree, *others) -> List[tuple]:
    """The leaves of trees of one structure side by side, matched as
    tree_map_multi matches them: [(leaf, *other leaves)]."""
    out: List[tuple] = []
    tree_map_multi(lambda *leaves: out.append(leaves), tree, *others)
    return out


# ---- JAX's flatten order, leaves named as jax.tree_util.keystr names them --


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_keys(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr, leaf)] in JAX's flatten order: dict keys sorted (DictKey
    `['k']`), list and tuple positions (SequenceKey `[i]`), namedtuple
    fields in order (GetAttrKey `.f`); None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_keys(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += flatten_with_keys(getattr(tree, f), f"{prefix}.{f}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_keys(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def unflatten_like(template, leaves):
    """template's structure (dicts keep their own key order) with its
    leaves replaced, in flatten_with_keys order, from `leaves`."""
    it = iter(leaves)

    def go(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: go(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*[go(getattr(t, f)) for f in t._fields])
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return next(it)

    return go(template)
