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


def _flat_outputs(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat_outputs(o)]
    return [out]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def op_parity(jax_fn, torch_fn, args, *, tol=1e-5, exact=False, diff=(),
              grad_tol=1e-5, seed=0, jit=True):
    """jax_fn(*args) against torch_fn(*args) on the same numpy inputs
    (each arg goes to jnp.asarray on one side and torch.from_numpy on the
    other; use closures for keywords). Every output must have the same
    shape; floats agree within `tol` of the output's max |value| (max
    abs error over max |want|), integer and bool outputs exactly (and
    floats too where exact=True). `diff` names the args to differentiate:
    the gradients of sum(out_i * c_i) over the float outputs, with seeded
    random cotangents c_i, agree within grad_tol the same way. The JAX
    side runs under jax.jit (eager op-by-op dispatch compiles every
    primitive), unless jit=False (a function that reads concrete values
    while it traces). Returns the port's outputs."""
    wrap = jax.jit if jit else (lambda f: f)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(np.array(a)) for a in args]
    want = _flat_outputs(wrap(jax_fn)(*jargs))
    got = _flat_outputs(torch_fn(*targs))
    assert len(want) == len(got), (len(want), len(got))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if exact or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=f"output {i}")
        else:
            err = rel_err(g, w)
            assert err <= tol, (i, err)
    if diff:
        rs = np.random.RandomState(seed)
        floats = [i for i, w in enumerate(want)
                  if np.issubdtype(np.asarray(w).dtype, np.floating)]
        cots = {i: rs.standard_normal(np.shape(want[i])).astype(np.float32)
                for i in floats}

        def jscalar(*vals):
            a = list(jargs)
            for k, v in zip(diff, vals):
                a[k] = v
            outs = _flat_outputs(jax_fn(*a))
            return sum(jnp.sum(outs[i] * cots[i]) for i in floats)

        jg = wrap(jax.grad(jscalar, argnums=tuple(range(len(diff)))))(
            *[jargs[k] for k in diff])
        for k in diff:
            targs[k] = targs[k].clone().requires_grad_(True)
        outs = _flat_outputs(torch_fn(*targs))
        s = sum((outs[i] * torch.from_numpy(cots[i])).sum() for i in floats)
        tg = torch.autograd.grad(s, [targs[k] for k in diff])
        for k, g, w in zip(diff, tg, jg):
            err = rel_err(g, np.asarray(w))
            assert err <= grad_tol, ("grad", k, err)
    return got
