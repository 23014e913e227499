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


# -- every optimizer, the schedules, averaging, hooks, the opt-state bridge --

from paddle_tpu.optim import average as JA
from paddle_tpu.optim import hooks as JH
from paddle_tpu.optim import schedules as JSC
from paddle_tpu_torch.models.weights import (opt_state_from_numpy,
                                             opt_state_to_numpy)
from paddle_tpu_torch.optim import average as TA
from paddle_tpu_torch.optim import hooks as TH


def _decay_kernels(name):
    return name.endswith("a") or name.endswith("d")


#: (name, kwargs without learning_rate, base lr); every optimizer runs
#: under exp_decay(base lr, 0.8, 1), a schedule that moves every step
OPTIMIZERS = [
    ("sgd", {}, 0.1),
    ("momentum", dict(mu=0.9), 0.05),
    ("momentum", dict(mu=0.8, nesterov=True), 0.05),
    ("adagrad", {}, 0.1),
    ("decayed_adagrad", dict(decay=0.9), 0.1),
    ("adadelta", dict(rho=0.9), 1.0),
    ("rmsprop", {}, 0.01),
    ("rmsprop", dict(momentum_mu=0.9), 0.01),
    ("adam", {}, 1e-2),
    ("adamax", {}, 1e-2),
    ("ftrl", dict(l1=0.01, l2=0.01), 0.1),
    ("lbfgs", dict(history=3), 0.5),
    ("owlqn", dict(l1=0.05, history=3), 0.5),
    ("proximal_gd", dict(l1=0.01, l2=0.01), 0.1),
    ("chain", dict(weight_decay=0.1, clip_global_norm=1.0, clip_value=0.5,
                   decay_mask=_decay_kernels), 1e-2),
]
OPT_IDS = ["sgd", "momentum", "nesterov", "adagrad", "decayed_adagrad",
           "adadelta", "rmsprop", "rmsprop_momentum", "adam", "adamax",
           "ftrl", "lbfgs", "owlqn", "proximal_gd", "chain"]


def _make(mod, sched_mod, name, kwargs, lr):
    sched = sched_mod.exp_decay(lr, 0.8, 1.0)
    if name == "chain":
        return mod.chain(mod.adam(sched), **kwargs)
    return getattr(mod, name)(learning_rate=sched, **kwargs)


def _tol(name):
    # updates with reductions over every parameter (the L-BFGS dots)
    return 1e-4 if name in ("lbfgs", "owlqn") else 1e-5


#: a separable quadratic 0.5 * h * (p - target)^2 per leaf: gradients
#: follow the parameters, so the curvature pairs of L-BFGS are real
_H = {"b": {"d": np.linspace(0.5, 2.0, 6).reshape(2, 3).astype(np.float32),
            "c": np.linspace(1.0, 3.0, 5).astype(np.float32)},
      "a": np.linspace(0.2, 1.5, 12).reshape(3, 4).astype(np.float32)}
_TARGET = {"b": {"d": np.full((2, 3), 0.3, np.float32),
                 "c": np.full(5, -0.2, np.float32)},
           "a": np.full((3, 4), 0.1, np.float32)}


def _jgrads(params):
    return jax.tree_util.tree_map(lambda p, h, t: h * (p - t), params, _H,
                                  _TARGET)


def _tgrads(params):
    h, t = (params_from_numpy(x, device="cpu") for x in (_H, _TARGET))
    return {"a": h["a"] * (params["a"] - t["a"]),
            "b": {"d": h["b"]["d"] * (params["b"]["d"] - t["b"]["d"]),
                  "c": h["b"]["c"] * (params["b"]["c"] - t["b"]["c"])}}


def _start():
    # insertion order "b" before "a", "d" before "c": the L-BFGS flat
    # state must follow JAX's sorted order all the same
    rs = np.random.RandomState(5)
    return {"b": {"d": rs.standard_normal((2, 3)).astype(np.float32),
                  "c": rs.standard_normal(5).astype(np.float32)},
            "a": rs.standard_normal((3, 4)).astype(np.float32)}


def _jax_steps(jopt, jp, js, first, n):
    for k in range(first, first + n):
        jp, js = jopt.update(_jgrads(jp), js, jp, jnp.asarray(k, jnp.int32))
    return jp, js


@pytest.mark.parametrize("name,kwargs,lr", OPTIMIZERS, ids=OPT_IDS)
def test_three_updates_match_jax(name, kwargs, lr):
    jopt = _make(JO, JSC, name, kwargs, lr)
    topt = _make(TO, TS, name, kwargs, lr)
    jp = jax.tree_util.tree_map(jnp.asarray, _start())
    js = jopt.init(jp)
    tp = params_from_numpy(_start(), device="cpu")
    ts = topt.init(tp)
    for k in range(3):
        jp, js = _jax_steps(jopt, jp, js, k, 1)
        tp, ts = topt.update(_tgrads(tp), ts, tp,
                             torch.tensor(k, dtype=torch.int32))
        _assert_trees(tp, jp, tol=_tol(name))
        _assert_trees(ts, js, tol=_tol(name))


@pytest.mark.parametrize("name,kwargs,lr", OPTIMIZERS, ids=OPT_IDS)
def test_opt_state_bridge_continues_a_jax_run(name, kwargs, lr):
    """3 JAX updates, the params and optimizer state across the bridge,
    3 port updates: equal to 6 JAX updates. The state crosses back
    unchanged, in JAX's tree."""
    jopt = _make(JO, JSC, name, kwargs, lr)
    topt = _make(TO, TS, name, kwargs, lr)
    jp = jax.tree_util.tree_map(jnp.asarray, _start())
    jp, js = _jax_steps(jopt, jp, jopt.init(jp), 0, 3)
    host_state = jax.device_get(js)
    ts = opt_state_from_numpy(host_state, device="cpu")
    back = opt_state_to_numpy(ts)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(host_state))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(host_state)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    for k in range(3, 6):
        tp, ts = topt.update(_tgrads(tp), ts, tp,
                             torch.tensor(k, dtype=torch.int32))
    jp, js = _jax_steps(jopt, jp, js, 3, 3)
    _assert_trees(tp, jp, tol=_tol(name))
    _assert_trees(ts, js, tol=_tol(name))


def test_lbfgs_flat_state_follows_jax_order():
    tp = params_from_numpy(_start(), device="cpu")
    st = TO.lbfgs(history=4).init(tp)
    total = 12 + 5 + 6
    assert st["s"].shape == st["y"].shape == (4, total)
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0
    TO.lbfgs(history=4).update(_tgrads(tp), st, tp,
                               torch.tensor(0, dtype=torch.int32))
    # prev_x is a (sorted keys), then b/c, then b/d
    flat = np.concatenate([_start()["a"].ravel(), _start()["b"]["c"],
                           _start()["b"]["d"].ravel()])
    np.testing.assert_array_equal(st["prev_x"].numpy(), flat)


def test_owlqn_requires_l1():
    with pytest.raises(ValueError, match="l1 > 0"):
        TO.owlqn(l1=0.0)


def test_get_knows_every_optimizer_and_names_them_on_a_typo():
    for name in ("sgd", "momentum", "adagrad", "decayed_adagrad",
                 "adadelta", "rmsprop", "adam", "adamax", "ftrl", "lbfgs",
                 "owlqn", "proximal_gd"):
        assert isinstance(TO.get(name), TO.Optimizer)
    with pytest.raises(ValueError) as tv:
        TO.get("adamm")
    with pytest.raises(ValueError) as jv:
        JO.get("adamm")
    assert str(tv.value) == str(jv.value)
    assert "'adam'" in str(tv.value) and "'lbfgs'" in str(tv.value)


def test_with_transforms_is_chain():
    grads = _tree(np.random.RandomState(8), scale=3.0)
    jopt = JO.sgd(0.1).with_transforms(weight_decay=0.1, clip_value=1.0)
    topt = TO.sgd(0.1).with_transforms(weight_decay=0.1, clip_value=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(np.random.RandomState(9)))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    jp, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), (), jp,
                        jnp.asarray(0, jnp.int32))
    tp, _ = topt.update(params_from_numpy(grads, device="cpu"), (), tp,
                        torch.tensor(0, dtype=torch.int32))
    _assert_trees(tp, jp)


@pytest.mark.parametrize("value", [0.3, 10.0])
def test_clip_by_value_matches_jax(value):
    grads = _tree(np.random.RandomState(4), scale=2.0)
    jg = JO.clip_by_value(jax.tree_util.tree_map(jnp.asarray, grads), value)
    tg = TO.clip_by_value(params_from_numpy(grads, device="cpu"), value)
    _assert_trees(tg, jg, tol=0.0)


SCHEDULES = [
    ("constant", (0.25,)),
    ("poly", (0.1, 0.5, 0.75)),
    ("inv", (0.1, 0.01, 0.75)),
    ("exp_decay", (0.1, 0.9, 3.0)),
    ("discrete_exp", (0.1, 0.5, 4.0)),
    ("linear_decay", (0.1, 0.004, 0.02)),
    ("piecewise", ([3, 7, 12], [0.1, 0.05, 0.01, 0.001])),
    ("warmup_cosine", (0.1, 5, 20, 0.001)),
]


@pytest.mark.parametrize("name,args", SCHEDULES,
                         ids=[n for n, _ in SCHEDULES])
def test_schedules_match_jax_at_every_step(name, args, monkeypatch):
    jfn, tfn = getattr(JSC, name)(*args), getattr(TS, name)(*args)
    # no schedule reads a value back to the host
    monkeypatch.setattr(torch.Tensor, "item", lambda self: pytest.fail(
        f"{name} called .item()"))
    for k in range(25):
        got = tfn(torch.tensor(k, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.device == torch.device("cpu")
        want = float(jfn(jnp.asarray(k, jnp.int32)))
        assert abs(float(got) - want) <= 1e-6 * abs(want) + 1e-12, (k, got,
                                                                     want)


def test_model_average_matches_jax():
    rs = np.random.RandomState(11)
    seq = [_tree(rs) for _ in range(5)]
    for window in (0.0, 3.0):
        js = JA.init(jax.tree_util.tree_map(jnp.asarray, seq[0]))
        ts = TA.init(params_from_numpy(seq[0], device="cpu"))
        _assert_trees(TA.averaged_params(
            ts, params_from_numpy(seq[0], device="cpu")),
            JA.averaged_params(js, jax.tree_util.tree_map(jnp.asarray,
                                                          seq[0])), tol=0.0)
        for p in seq:
            jp = jax.tree_util.tree_map(jnp.asarray, p)
            tp = params_from_numpy(p, device="cpu")
            js = JA.accumulate(js, jp, max_average_window=window)
            ts = TA.accumulate(ts, tp, max_average_window=window)
            assert float(ts["count"]) == float(js["count"])
            _assert_trees(TA.averaged_params(ts, tp),
                          JA.averaged_params(js, jp))


def test_magnitude_masks_and_pruning_match_jax():
    params = _tree(np.random.RandomState(12))
    params["b"]["c"][:] = 0.5      # ties: the lower index is kept first
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    match = lambda name: not name.startswith("b/d")
    jm = JH.magnitude_masks(jp, 0.5, match=match)
    tm = TH.magnitude_masks(tp, 0.5, match=match)
    for a, b in zip(tree_leaves(tm), jax.tree_util.tree_leaves(jm)):
        assert a.dtype == torch.bool
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(tm["a"].sum()) == 6 and bool(tm["b"]["d"].all())
    grads = _tree(np.random.RandomState(13))
    jopt = JH.with_pruning(JO.momentum(0.1), jm)
    topt = TH.with_pruning(TO.momentum(0.1), tm)
    js, ts = jopt.init(jp), topt.init(tp)
    for k in range(2):
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                             jp, jnp.asarray(k, jnp.int32))
        tp, ts = topt.update(params_from_numpy(grads, device="cpu"), ts, tp,
                             torch.tensor(k, dtype=torch.int32))
    _assert_trees(tp, jp)
    assert float(tp["a"][~tm["a"]].abs().max()) == 0.0


def test_update_hook_sees_the_updated_params_and_step():
    seen = []

    def hook(params, step):
        seen.append(int(step))
        return {k: v for k, v in params.items()}

    opt = TH.with_update_hook(TO.sgd(0.1), hook)
    tp = params_from_numpy(_tree(np.random.RandomState(14)), device="cpu")
    before = tp["a"].clone()
    new, _ = opt.update(params_from_numpy(_tree(np.random.RandomState(15)),
                                          device="cpu"), (), tp,
                        torch.tensor(4, dtype=torch.int32))
    assert seen == [4] and not torch.equal(new["a"], before)
