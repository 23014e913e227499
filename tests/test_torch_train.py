"""The port's training stack against the JAX package's: `make_train_step`
on the bench_lstm-shaped classifier, `Trainer.train`/`evaluate` with
events, `text_lstm` on ragged lengths with max pooling, the TrainState
bridge, and the layer, loss and pooling pieces they rest on.

The same weights go in on both sides (the JAX initializer draws them,
`params_from_numpy` carries them over), the same numpy batches, and the
losses and parameters must agree within 1e-5 (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models import text_lstm as JTL
from paddle_tpu.ops import losses as JL
from paddle_tpu.ops import sequence as JSQ
from paddle_tpu.optim import optimizers as JO
from paddle_tpu.train import events as JE
from paddle_tpu.train import state as JS
from paddle_tpu.train import trainer as JT
from paddle_tpu_torch.core.pytree import tree_leaves
from paddle_tpu_torch.models import text_lstm as TTL
from paddle_tpu_torch.models.weights import (
    params_from_numpy,
    params_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from paddle_tpu_torch.nn import layers as TNL
from paddle_tpu_torch.nn import module as TNM
from paddle_tpu_torch.nn import recurrent as TNR
from paddle_tpu_torch.ops import losses as TL
from paddle_tpu_torch.ops import sequence as TSQ
from paddle_tpu_torch.optim import optimizers as TO
from paddle_tpu_torch.train import events as TE
from paddle_tpu_torch.train import state as TS
from paddle_tpu_torch.train import trainer as TT
from torch_parity import np_f32, to_jax, to_torch

VOCAB, HID, B, T = 50, 16, 4, 7


def _jax_model():
    return jnn.Sequential([
        jnn.Embedding(VOCAB, HID, name="emb"),
        jnn.LSTM(HID, name="lstm1"),
        jnn.LSTM(HID, name="lstm2"),
        jnn.Lambda(lambda x: x.mean(axis=1), name="pool",
                   out_spec_fn=lambda s: jnn.ShapeSpec(
                       (s.shape[0], s.shape[2]), s.dtype)),
        jnn.Dense(2, name="fc"),
    ])


def _torch_model(impl=None):
    return TNM.Sequential([
        TNL.Embedding(VOCAB, HID, name="emb"),
        TNR.LSTM(HID, name="lstm1", impl=impl),
        TNR.LSTM(HID, name="lstm2", impl=impl),
        TNL.Lambda(lambda x: x.mean(dim=1), name="pool",
                   out_spec_fn=lambda s: TNM.ShapeSpec(
                       (s.shape[0], s.shape[2]), s.dtype)),
        TNL.Dense(2, name="fc"),
    ])


def _jloss(lo, la):
    return jnp.mean(JL.softmax_cross_entropy(lo, la))


def _tloss(lo, la):
    return torch.mean(TL.softmax_cross_entropy(lo, la))


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, (B, T)).astype(np.int32),
             rs.randint(0, 2, B).astype(np.int32)) for _ in range(n)]


def _jax_params(model):
    jp, js = model.init(jax.random.key(0),
                        jnn.ShapeSpec((B, T), jnp.int32))
    # a larger embedding scale than the initializer's 0.01 so the LSTMs
    # see inputs of unit order and the parity test is not a weak one
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    jp["emb"]["table"] = jp["emb"]["table"] * 50.0
    return jp, js


def _assert_trees(got, want, tol=1e-5):
    g = tree_leaves(params_to_numpy(got))
    w = jax.tree_util.tree_leaves(jax.device_get(want))
    assert [a.shape for a in g] == [tuple(np.shape(b)) for b in w]
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=0,
                                   atol=tol)


@pytest.fixture(params=["xla", "pallas"])
def jax_rnn_impl(request, monkeypatch):
    """The JAX side's LSTM path: its scan, or its Pallas kernels (in
    interpret mode), through the package's environment override."""
    monkeypatch.setenv("PADDLE_TPU_RNN_IMPL", request.param)
    return request.param


def test_sequential_tree_matches_jax():
    jp, _ = _jax_params(_jax_model())
    tp, ts = _torch_model().init(0, TNM.ShapeSpec((B, T), torch.int32),
                                 device="cpu")
    assert ts == {}
    shapes = lambda tree: jax.tree_util.tree_map(np.shape, tree)
    assert shapes(params_to_numpy(tp)) == shapes(jax.device_get(jp))
    assert sorted(tp) == ["emb", "fc", "lstm1", "lstm2"]
    assert _torch_model().out_spec(
        TNM.ShapeSpec((B, T), torch.int32)).shape == (B, 2)


def test_make_train_step_matches_jax(jax_rnn_impl):
    jmodel = _jax_model()
    jp, js = _jax_params(jmodel)
    jopt, topt = JO.adam(1e-2), TO.adam(1e-2)
    jstate = JS.TrainState.create(jp, js, jopt)
    jstep = JT.make_train_step(jmodel, _jloss, jopt, donate=False)
    tstate = TS.TrainState.create(
        params_from_numpy(jax.device_get(jp), device="cpu"), {}, topt)
    tstep = TT.make_train_step(_torch_model(), _tloss, topt)
    for x, y in _batches(3):
        jstate, jl, _ = jstep(jstate, jax.random.key(1), (to_jax(x),),
                              (to_jax(y),))
        tstate, tl, _ = tstep(tstate, None, (to_torch(x),), (to_torch(y),))
        assert abs(float(tl) - float(jl)) <= 1e-5
    assert int(tstate.step) == int(jstate.step) == 3
    _assert_trees(tstate.params, jstate.params)
    _assert_trees(tstate.opt_state, jstate.opt_state)


def test_trainer_train_and_evaluate_match_jax():
    jmodel = _jax_model()
    jp, js = _jax_params(jmodel)
    train, test = _batches(3, seed=1), _batches(2, seed=2)
    jtr = JT.Trainer(jmodel, _jloss, JO.adam(1e-2))
    ttr = TT.Trainer(_torch_model(), _tloss, TO.adam(1e-2), device="cpu")
    # before JAX's step donates (deletes) the arrays
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    jev, tev = [], []
    jstate = jtr.train(
        JS.TrainState.create(jp, js, jtr.optimizer),
        lambda: [(to_jax(x), to_jax(y)) for x, y in train], num_passes=2,
        event_handler=jev.append,
        test_iter_factory=lambda: [(to_jax(x), to_jax(y)) for x, y in test])
    tstate = ttr.train(
        TS.TrainState.create(tp, {}, ttr.optimizer),
        lambda: train, num_passes=2, event_handler=tev.append,
        test_iter_factory=lambda: test)
    assert [type(e).__name__ for e in tev] == [type(e).__name__ for e in jev]
    assert [type(e).__name__ for e in tev[:3]] == [
        "BeginPass", "BeginIteration", "EndIteration"]
    for je, te in zip(jev, tev):
        if isinstance(te, TE.EndIteration):
            assert isinstance(je, JE.EndIteration)
            assert (te.pass_id, te.batch_id) == (je.pass_id, je.batch_id)
            assert abs(te.cost - je.cost) <= 1e-5
        if isinstance(te, TE.TestResult):
            assert abs(te.cost - je.cost) <= 1e-5
    assert int(tstate.step) == 6
    _assert_trees(tstate.params, jstate.params)
    jres = jtr.evaluate(jstate, lambda: [(to_jax(x), to_jax(y))
                                         for x, y in test])
    tres = ttr.evaluate(tstate, lambda: test)
    assert abs(tres.cost - jres.cost) <= 1e-5


def test_trainer_init_state():
    ttr = TT.Trainer(_torch_model(), _tloss, TO.adam(1e-3), seed=3,
                     device="cpu")
    st = ttr.init_state(TNM.ShapeSpec((B, T), torch.int32))
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert sorted(st.opt_state) == ["m", "v"]
    assert [t.shape for t in tree_leaves(st.opt_state["m"])] == \
        [t.shape for t in tree_leaves(st.params)]
    again = TT.Trainer(_torch_model(), _tloss, TO.adam(1e-3), seed=3,
                       device="cpu").init_state(
        TNM.ShapeSpec((B, T), torch.int32))
    for a, b in zip(tree_leaves(st.params), tree_leaves(again.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("what", ["remat", "accum_steps",
                                  "constrain_state_fn", "aux_loss_weight"])
def test_train_step_options_not_ported_raise(what):
    """The four options of make_train_step raised NotImplementedError
    until they were ported; now each is taken. On this model (no dropout,
    no aux_loss leaf) a step with the option gives the plain step's loss
    and parameters: remat and aux_loss_weight exactly, accum_steps=2 (the
    mean of two microbatch means) within f32 rounding; constrain_state_fn
    sees and replaces the new state. A batch accum_steps does not divide
    raises ValueError, as in JAX (tests/test_torch_trainer_options.py
    holds each option against JAX)."""
    seen = []
    kw = {"remat": dict(remat=True), "accum_steps": dict(accum_steps=2),
          "constrain_state_fn": dict(
              constrain_state_fn=lambda s: seen.append(s) or s),
          "aux_loss_weight": dict(aux_loss_weight=0.1)}[what]
    jp, _ = _jax_params(_jax_model())
    (x, y), = _batches(1, seed=7)
    runs = []
    for options in ({}, kw):
        state = TS.TrainState.create(
            params_from_numpy(jax.device_get(jp), device="cpu"), {},
            TO.sgd(0.1))
        step = TT.make_train_step(_torch_model(), _tloss, TO.sgd(0.1),
                                  **options)
        state, loss, _ = step(state, None, (to_torch(x),), (to_torch(y),))
        runs.append((state, float(loss)))
    (plain, plain_loss), (opt, opt_loss) = runs
    tol = 1e-6 if what == "accum_steps" else 0.0
    assert abs(opt_loss - plain_loss) <= tol
    for a, b in zip(tree_leaves(opt.params), tree_leaves(plain.params)):
        assert float((a - b).abs().max()) <= tol
    if what == "constrain_state_fn":
        assert len(seen) == 1 and seen[0] is opt
    if what == "accum_steps":
        step = TT.make_train_step(_torch_model(), _tloss, TO.sgd(),
                                  accum_steps=3)
        with pytest.raises(ValueError, match="not divisible"):
            step(opt, None, (to_torch(x),), (to_torch(y),))


def test_text_lstm_ragged_max_pool_matches_jax(jax_rnn_impl):
    rs = np.random.RandomState(5)
    jp = JTL.init_params(jax.random.key(2), VOCAB, embed_dim=12, hidden=HID)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    jp["embed"] = jp["embed"] * 20.0
    tokens = rs.randint(0, VOCAB, (B, T)).astype(np.int32)
    lens = np.array([7, 3, 5, 1], np.int32)
    labels = rs.randint(0, 2, B).astype(np.int32)

    def jloss(p):
        lo = JTL.apply(p, to_jax(tokens), to_jax(lens), pool="max")
        return _jloss(lo, to_jax(labels)), lo

    (jl, jlo), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tlo = TTL.apply(tp, to_torch(tokens), to_torch(lens), pool="max")
    tl = _tloss(tlo, to_torch(labels))
    np.testing.assert_allclose(tlo.detach().numpy(), np.asarray(jlo),
                               rtol=0, atol=1e-5)
    assert abs(tl.item() - float(jl)) <= 1e-5
    tg = torch.autograd.grad(tl, leaves)
    for a, b in zip(tg, jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= 1e-4 * max(np.abs(b).max(),
                                                          1e-30)


def test_text_lstm_init_tree_matches_jax():
    jp = JTL.init_params(jax.random.key(0), VOCAB, embed_dim=12, hidden=HID,
                         num_layers=3)
    tp = TTL.init_params(0, VOCAB, embed_dim=12, hidden=HID, num_layers=3,
                         device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(np.shape, tree)
    assert shapes(params_to_numpy(tp)) == shapes(jax.device_get(jp))
    # the forget-gate block of each bias starts at 1
    assert torch.equal(tp["lstm0"]["b"][HID:2 * HID], torch.ones(HID))


def test_train_state_bridge_continues_a_jax_run():
    """A JAX state after two adam steps crosses to the port, and both
    take a third step on the same batch; the port's state crosses back
    unchanged."""
    jmodel = _jax_model()
    jp, js = _jax_params(jmodel)
    jopt = JO.adam(1e-2)
    jstep = JT.make_train_step(jmodel, _jloss, jopt, donate=False)
    jstate = JS.TrainState.create(jp, js, jopt)
    (x0, y0), (x1, y1), (x2, y2) = _batches(3, seed=4)
    for x, y in ((x0, y0), (x1, y1)):
        jstate, _, _ = jstep(jstate, jax.random.key(0), (to_jax(x),),
                             (to_jax(y),))
    tstate = train_state_from_numpy(jax.device_get(jstate), device="cpu")
    assert tstate.step.dtype == torch.int32 and int(tstate.step) == 2
    _assert_trees(tstate.opt_state, jstate.opt_state, tol=0.0)

    back = train_state_to_numpy(tstate)
    rebuilt = JS.TrainState(*back)
    for a, b in zip(jax.tree_util.tree_leaves(rebuilt),
                    jax.tree_util.tree_leaves(jax.device_get(jstate))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    jstate, jl, _ = jstep(jstate, jax.random.key(0), (to_jax(x2),),
                          (to_jax(y2),))
    tstep = TT.make_train_step(_torch_model(), _tloss, TO.adam(1e-2))
    tstate, tl, _ = tstep(tstate, None, (to_torch(x2),), (to_torch(y2),))
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert int(tstate.step) == 3
    _assert_trees(tstate.params, jstate.params)
    _assert_trees(tstate.opt_state, jstate.opt_state)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy_matches_jax(smoothing):
    rs = np.random.RandomState(6)
    logits = np_f32(rs, 5, 7) * 3
    labels = rs.randint(0, 7, 5).astype(np.int32)
    want = JL.softmax_cross_entropy(to_jax(logits), to_jax(labels),
                                    label_smoothing=smoothing)
    got = TL.softmax_cross_entropy(to_torch(logits), to_torch(labels),
                                   label_smoothing=smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean", "sqrt", "max", "last",
                                  "first"])
def test_dense_sequence_pool_matches_jax(mode):
    rs = np.random.RandomState(7)
    x = np_f32(rs, 4, 6, 3)
    lens = np.array([6, 2, 0, 4], np.int32)
    w = np_f32(rs, 4, 3)
    jfn = lambda a: jnp.sum(JSQ.dense_sequence_pool(a, to_jax(lens), mode)
                            * w)
    jv, jg = jax.value_and_grad(jfn)(to_jax(x))
    tx = to_torch(x).requires_grad_(True)
    tv = torch.sum(TSQ.dense_sequence_pool(tx, to_torch(lens), mode)
                   * to_torch(w))
    (tg,) = torch.autograd.grad(tv, [tx])
    assert abs(tv.item() - float(jv)) <= 1e-5
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        TSQ.length_mask(to_torch(lens), 6).numpy(),
        np.asarray(JSQ.length_mask(to_jax(lens), 6)))


def test_max_pool_splits_a_tie_like_jax():
    x = np.zeros((1, 3, 1), np.float32)
    x[0, 0, 0] = x[0, 2, 0] = 2.0
    lens = np.array([3], np.int32)
    jg = jax.grad(lambda a: jnp.sum(
        JSQ.dense_sequence_pool(a, to_jax(lens), "max")))(to_jax(x))
    tx = to_torch(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(
        TSQ.dense_sequence_pool(tx, to_torch(lens), "max").sum(), [tx])
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("activation", [None, "relu", "tanh", "sigmoid"])
def test_dense_and_embedding_match_jax(activation):
    rs = np.random.RandomState(8)
    jd, je = jnn.Dense(5, activation=activation), jnn.Embedding(VOCAB, 4)
    jdp, _ = jd.init(jax.random.key(0), jnn.ShapeSpec((3, 4)))
    jep, _ = je.init(jax.random.key(1), jnn.ShapeSpec((3, 6), jnp.int32))
    ids = rs.randint(0, VOCAB, (3, 6)).astype(np.int32)
    jemb = je.apply(jep, {}, to_jax(ids))[0]
    jy = jd.apply(jdp, {}, jemb)[0]
    td, te = TNL.Dense(5, activation=activation), TNL.Embedding(VOCAB, 4)
    tdp = params_from_numpy(jax.device_get(jdp), device="cpu")
    tep = params_from_numpy(jax.device_get(jep), device="cpu")
    temb = te.apply(tep, {}, to_torch(ids))[0]
    ty = td.apply(tdp, {}, temb)[0]
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), rtol=0,
                               atol=0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy, np.float32),
                               rtol=0, atol=1e-6)
    tp, _ = td.init(0, TNM.ShapeSpec((3, 4)), device="cpu")
    assert tp["kernel"].shape == (4, 5) and torch.equal(tp["bias"],
                                                        torch.zeros(5))
    assert float(tp["kernel"].abs().max()) <= 0.5   # smart: 1/sqrt(4)


def test_module_helpers():
    with pytest.raises(ValueError, match="duplicate layer name"):
        TNM.Sequential([TNL.Dense(2, name="a"), TNL.Dense(2, name="a")]).init(
            0, TNM.ShapeSpec((1, 2)), device="cpu")
    with pytest.raises(ValueError, match="unknown activation"):
        TNL.Dense(2, activation="swishy")
    with pytest.raises(ValueError, match="unknown initializer"):
        TNL.Dense(2, kernel_init="orthogonalish")
    merged = TNM.merge_state({"a": {"x": 1, "y": 2}, "b": 3},
                             {"a": {"y": 5}, "c": 4})
    assert merged == {"a": {"x": 1, "y": 5}, "b": 3, "c": 4}
