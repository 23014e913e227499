"""The port's optimizers against the JAX package's: five updates on the
same gradients give the same parameters and moments (1e-6), including
adam's bias correction with eps outside it (not torch.optim.Adam's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.optim import optimizers as JO
from paddle_tpu_torch.core.pytree import tree_leaves
from paddle_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from paddle_tpu_torch.optim import optimizers as TO
from paddle_tpu_torch.optim import schedules as TS

SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3)}}


def _tree(rs, scale=1.0):
    return {"a": (rs.standard_normal((3, 4)) * scale).astype(np.float32),
            "b": {"c": (rs.standard_normal(5) * scale).astype(np.float32),
                  "d": (rs.standard_normal((2, 3)) * scale).astype(
                      np.float32)}}


def _assert_trees(got, want, tol=1e-6):
    g = jax.tree_util.tree_leaves(params_to_numpy(got))
    w = jax.tree_util.tree_leaves(jax.device_get(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", dict(learning_rate=0.1)),
    ("momentum", dict(learning_rate=0.05, mu=0.9)),
    ("momentum", dict(learning_rate=0.05, mu=0.8, nesterov=True)),
    ("adam", dict(learning_rate=1e-2)),
    ("adam", dict(learning_rate=3e-3, beta1=0.8, beta2=0.99, epsilon=1e-6)),
], ids=["sgd", "momentum", "nesterov", "adam", "adam_betas"])
def test_five_updates_match_jax(name, kwargs):
    rs = np.random.RandomState(0)
    params = _tree(rs)
    jopt, topt = getattr(JO, name)(**kwargs), getattr(TO, name)(**kwargs)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = params_from_numpy(params, device="cpu")
    ts = topt.init(tp)
    for k in range(5):
        # the same gradients every update: a trajectory that exercises
        # the moments' growth and adam's bias correction over steps
        grads = _tree(np.random.RandomState(100), scale=0.5)
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                             jp, jnp.asarray(k, jnp.int32))
        tp, ts = topt.update(params_from_numpy(grads, device="cpu"), ts, tp,
                             torch.tensor(k, dtype=torch.int32))
        _assert_trees(tp, jp)
        _assert_trees(ts, js)


def test_updates_are_in_place():
    rs = np.random.RandomState(1)
    tp = params_from_numpy(_tree(rs), device="cpu")
    opt = TO.adam(1e-3)
    st = opt.init(tp)
    before = [t.data_ptr() for t in tree_leaves(tp) + tree_leaves(st)]
    new_p, new_s = opt.update(params_from_numpy(_tree(rs), device="cpu"), st,
                              tp, torch.tensor(0, dtype=torch.int32))
    assert new_p is tp and new_s is st
    assert [t.data_ptr() for t in
            tree_leaves(new_p) + tree_leaves(new_s)] == before


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(np.random.RandomState(2))
    jg, jn = JO.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
    tg, tn = TO.clip_by_global_norm(params_from_numpy(grads, device="cpu"),
                                    max_norm)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    _assert_trees(tg, jg)


def test_schedule_resolve():
    step = torch.tensor(3, dtype=torch.int32)
    lr = TS.resolve(0.25)(step)
    assert lr.dtype == torch.float32 and float(lr) == 0.25
    fn = lambda s: s.float() * 0.5
    assert TS.resolve(fn) is fn
