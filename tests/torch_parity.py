"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*):
one seeded parameter tree handed to both the JAX package and the port.

tests/conftest.py turns on jax_enable_x64, under which the JAX
`init_params` makes float64 LayerNorm vectors; every JAX leaf is cast to
float32 here so both sides compute in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.weights import params_from_numpy


def make_models(seed=0, embed_std=1.0, **cfg_kwargs):
    """(jax_cfg, torch_cfg, jax_params, torch_params) on the same weights.

    The JAX initializer draws the weights; the embedding table is
    rescaled to `embed_std` so a tiny random model's greedy tokens vary
    from step to step (at the initializer's 0.02 they collapse onto one
    token, which makes a weak parity test)."""
    jcfg = JT.TransformerConfig(**cfg_kwargs)
    tcfg = TT.TransformerConfig(**cfg_kwargs)
    jp = JT.init_params(jax.random.key(seed), jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    jp["embed"]["table"] = jp["embed"]["table"] * (embed_std / 0.02)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def np_f32(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def to_jax(x):
    return jnp.asarray(np.asarray(x))


def to_torch(x):
    return torch.from_numpy(np.array(x))


#: a leaf's scale in `tree_rel_errs` is floored at this fraction of the
#: largest |value| of any leaf of the reference tree (chip_smoke.py's
#: LEAF_FLOOR): a leaf whose reference is ~0 measures f32 cancellation
LEAF_FLOOR = 1e-6


def named_leaves(tree, prefix=""):
    """{path: float64 numpy array} of a nested dict/list tree of torch
    tensors, JAX arrays or numpy arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(named_leaves(v, f"{prefix}{i}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float().numpy()
    return {prefix.rstrip("/"): np.asarray(tree, np.float64)}


def rel_err(got, want):
    """max |got - want| over max |want| (floored at 1e-30)."""
    got = np.asarray(got.detach().float().numpy()
                     if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def tree_rel_errs(got, want):
    """{leaf: max abs error over the leaf's max |want|}, the scale floored
    at LEAF_FLOOR x the largest |want| of any leaf. The two trees must
    have the same leaves and shapes."""
    g, w = named_leaves(got), named_leaves(want)
    assert sorted(g) == sorted(w), (sorted(g), sorted(w))
    top = max((np.abs(a).max() for a in w.values() if a.size), default=0.0)
    errs = {}
    for k in w:
        assert g[k].shape == w[k].shape, (k, g[k].shape, w[k].shape)
        scale = max(np.abs(w[k]).max(), LEAF_FLOOR * top, 1e-30)
        errs[k] = float(np.abs(g[k] - w[k]).max() / scale)
    return errs


def assert_tree_close(got, want, tol):
    errs = tree_rel_errs(got, want)
    if errs:
        worst = max(errs, key=errs.get)
        assert errs[worst] <= tol, (worst, errs[worst])
