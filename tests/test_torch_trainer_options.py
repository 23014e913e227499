"""The options of the port's train step and Trainer against the JAX
package's: `make_train_step(accum_steps=k)` against JAX's own
accumulated step, `aux_loss_weight` on a layer that writes an `aux_loss`
into its state (defined on both sides), `constrain_state_fn`, `remat`
(gradients bit for bit equal to the plain step's, a Dropout's masks
replayed), `check_gradients` (float64), `parameter_stats`,
`Trainer.train`'s checkpoint cadence, `Trainer.evaluate(evaluators=)`,
and the dispatch rule that a kernel path given float64 raises.

The same weights go in on both sides (the JAX initializer draws them,
`params_from_numpy` carries them over) with the same numpy batches;
f32 tolerances 1e-5 unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import metrics as JM
from paddle_tpu import nn as jnn
from paddle_tpu.metrics import printer as JP
from paddle_tpu.ops import losses as JL
from paddle_tpu.optim import optimizers as JO
from paddle_tpu.train import checkpoint as JC
from paddle_tpu.train import state as JS
from paddle_tpu.train import trainer as JT
from paddle_tpu_torch import metrics as TM
from paddle_tpu_torch.core.pytree import tree_leaves
from paddle_tpu_torch.metrics import printer as TP
from paddle_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from paddle_tpu_torch.nn import layers as TNL
from paddle_tpu_torch.nn import module as TNM
from paddle_tpu_torch.nn import recurrent as TNR
from paddle_tpu_torch.ops import losses as TL
from paddle_tpu_torch.optim import optimizers as TO
from paddle_tpu_torch.train import checkpoint as TC
from paddle_tpu_torch.train import state as TS
from paddle_tpu_torch.train import trainer as TT
from torch_parity import to_jax, to_torch

VOCAB, HID, B, T = 40, 8, 8, 5


class JaxAux(jnn.Layer):
    """Identity that writes 0.5 * mean(x^2) into its state as aux_loss."""

    def __init__(self, name="aux"):
        self.name = name

    def _init(self, rng, spec, _abstract=False):
        return {}, {"aux_loss": jnp.zeros((), jnp.float32)}, spec

    def _apply(self, params, state, x, *, training, rng):
        return x, {"aux_loss": 0.5 * jnp.mean(jnp.square(x))}


class TorchAux(TNM.Layer):
    def __init__(self, name="aux"):
        self.name = name

    def _init(self, rng, spec, _abstract=False):
        return {}, {"aux_loss": torch.zeros(())}, spec

    def _apply(self, params, state, x, *, training, rng):
        return x, {"aux_loss": 0.5 * torch.mean(torch.square(x))}


def _jax_model(aux=False):
    return jnn.Sequential(
        [jnn.Embedding(VOCAB, HID, name="emb"),
         jnn.LSTM(HID, name="lstm1"), jnn.LSTM(HID, name="lstm2")]
        + ([JaxAux()] if aux else [])
        + [jnn.Lambda(lambda x: x.mean(axis=1), name="pool",
                      out_spec_fn=lambda s: jnn.ShapeSpec(
                          (s.shape[0], s.shape[2]), s.dtype)),
           jnn.Dense(2, name="fc")])


def _torch_model(aux=False, impl=None, dropout=0.0):
    return TNM.Sequential(
        [TNL.Embedding(VOCAB, HID, name="emb"),
         TNR.LSTM(HID, name="lstm1", impl=impl)]
        + ([TNL.Dropout(dropout, name="drop")] if dropout else [])
        + [TNR.LSTM(HID, name="lstm2", impl=impl)]
        + ([TorchAux()] if aux else [])
        + [TNL.Lambda(lambda x: x.mean(dim=1), name="pool",
                      out_spec_fn=lambda s: TNM.ShapeSpec(
                          (s.shape[0], s.shape[2]), s.dtype)),
           TNL.Dense(2, name="fc")])


def _jloss(lo, la):
    return jnp.mean(JL.softmax_cross_entropy(lo, la))


def _tloss(lo, la):
    return torch.mean(TL.softmax_cross_entropy(lo, la))


def _batches(n, seed=0, b=B):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, (b, T)).astype(np.int32),
             rs.randint(0, 2, b).astype(np.int32)) for _ in range(n)]


def _params(aux=False):
    jp, js = _jax_model(aux).init(jax.random.key(0),
                                  jnn.ShapeSpec((B, T), jnp.int32))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    jp["emb"]["table"] = jp["emb"]["table"] * 50.0
    js = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), js)
    return jp, js


def _assert_trees(got, want, tol=1e-5):
    g = tree_leaves(params_to_numpy(got))
    w = jax.tree_util.tree_leaves(jax.device_get(want))
    assert [a.shape for a in g] == [tuple(np.shape(b)) for b in w]
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=0,
                                   atol=tol)


def _grad_keeping(jax_side):
    """sgd(0.1) whose opt_state is the last gradient it applied: the JAX
    step returns no gradients, so they come back in the state."""
    if jax_side:
        return JO.Optimizer(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g, s, p, step: (jax.tree_util.tree_map(
                lambda a, b: a - 0.1 * b, p, g), g))

    @torch.no_grad()
    def update(g, s, p, step):
        for pi, gi, si in zip(tree_leaves(p), tree_leaves(g),
                              tree_leaves(s)):
            si.copy_(gi)
            pi.sub_(0.1 * gi)
        return p, s

    return TO.Optimizer(_zeros, update)


def _zeros(tree):
    return {k: (_zeros(v) if isinstance(v, dict) else torch.zeros_like(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("k", [2, 4])
def test_accum_steps_matches_jax_accumulated_step(k):
    jp, js = _params()
    jopt, topt = _grad_keeping(True), _grad_keeping(False)
    jstep = JT.make_train_step(_jax_model(), _jloss, jopt, donate=False,
                               accum_steps=k)
    tstep = TT.make_train_step(_torch_model(), _tloss, topt, accum_steps=k)
    jstate = JS.TrainState.create(jp, js, jopt)
    tstate = TS.TrainState.create(
        params_from_numpy(jax.device_get(jp), device="cpu"), {}, topt)
    for x, y in _batches(2, seed=1):
        jstate, jl, _ = jstep(jstate, jax.random.key(0), (to_jax(x),),
                              (to_jax(y),))
        tstate, tl, _ = tstep(tstate, None, (to_torch(x),), (to_torch(y),))
        assert abs(float(tl) - float(jl)) <= 1e-5
        _assert_trees(tstate.opt_state, jstate.opt_state)   # the gradients
        _assert_trees(tstate.params, jstate.params)
    # the mean of k microbatch gradients is the full batch's gradient
    x, y = _batches(1, seed=2)[0]
    _, _, g_full, _ = TT.loss_and_grads(
        _torch_model(), _tloss, tstate.params, {}, None, (to_torch(x),),
        (to_torch(y),))
    acc, _, _ = TT.make_train_step(_torch_model(), _tloss,
                                   _grad_keeping(False), donate=False,
                                   accum_steps=k)(
        tstate, None, (to_torch(x),), (to_torch(y),))
    for a, b in zip(tree_leaves(acc.opt_state), tree_leaves(g_full)):
        assert float((a - b).abs().max()) <= 1e-6


def test_accum_steps_refuses_a_batch_it_does_not_divide():
    tstep = TT.make_train_step(_torch_model(), _tloss, TO.sgd(),
                               accum_steps=3)
    tp, _ = _torch_model().init(0, TNM.ShapeSpec((B, T), torch.int32),
                                device="cpu")
    (x, y), = _batches(1)
    with pytest.raises(ValueError, match="not divisible by accum_steps=3"):
        tstep(TS.TrainState.create(tp, {}, TO.sgd()), None, (to_torch(x),),
              (to_torch(y),))
    with pytest.raises(ValueError, match="accum_steps"):
        TT.make_train_step(_torch_model(), _tloss, TO.sgd(), accum_steps=0)


def test_aux_loss_weight_matches_jax():
    jp, js = _params(aux=True)
    jopt, topt = JO.adam(1e-2), TO.adam(1e-2)
    jstep = JT.make_train_step(_jax_model(True), _jloss, jopt, donate=False,
                               aux_loss_weight=0.5)
    tstep = TT.make_train_step(_torch_model(True), _tloss, topt,
                               aux_loss_weight=0.5)
    jstate = JS.TrainState.create(jp, js, jopt)
    tstate = TS.TrainState.create(
        params_from_numpy(jax.device_get(jp), device="cpu"),
        params_from_numpy(jax.device_get(js), device="cpu"), topt)
    plain = TT.make_train_step(_torch_model(True), _tloss, TO.adam(1e-2),
                               donate=False)
    for x, y in _batches(3, seed=3):
        _, pl, _ = plain(tstate, None, (to_torch(x),), (to_torch(y),))
        jstate, jl, _ = jstep(jstate, jax.random.key(0), (to_jax(x),),
                              (to_jax(y),))
        tstate, tl, _ = tstep(tstate, None, (to_torch(x),), (to_torch(y),))
        assert abs(float(tl) - float(jl)) <= 1e-5
        # the cost includes 0.5 * aux_loss, which the plain step leaves out
        aux = float(tstate.model_state["aux"]["aux_loss"])
        assert aux > 0.0
        assert abs(float(tl) - float(pl) - 0.5 * aux) <= 1e-5
        assert not tstate.model_state["aux"]["aux_loss"].requires_grad
    _assert_trees(tstate.params, jstate.params)
    _assert_trees(tstate.model_state, jstate.model_state)


def test_constrain_state_fn_is_applied_to_the_new_state():
    jp, js = _params()
    clip = 0.05

    def jconstrain(st):
        return st._replace(params=jax.tree_util.tree_map(
            lambda p: jnp.clip(p, -clip, clip), st.params))

    def tconstrain(st):
        for p in tree_leaves(st.params):
            p.clamp_(-clip, clip)
        return st

    jopt, topt = JO.momentum(0.1), TO.momentum(0.1)
    jstep = JT.make_train_step(_jax_model(), _jloss, jopt, donate=False,
                               constrain_state_fn=jconstrain)
    tstep = TT.make_train_step(_torch_model(), _tloss, topt,
                               constrain_state_fn=tconstrain)
    jstate = JS.TrainState.create(jp, js, jopt)
    tstate = TS.TrainState.create(
        params_from_numpy(jax.device_get(jp), device="cpu"), {}, topt)
    for x, y in _batches(2, seed=4):
        jstate, jl, _ = jstep(jstate, jax.random.key(0), (to_jax(x),),
                              (to_jax(y),))
        tstate, tl, _ = tstep(tstate, None, (to_torch(x),), (to_torch(y),))
        assert abs(float(tl) - float(jl)) <= 1e-5
    assert max(float(p.abs().max()) for p in tree_leaves(tstate.params)) \
        <= float(np.float32(clip))
    _assert_trees(tstate.params, jstate.params)
    _assert_trees(tstate.opt_state, jstate.opt_state)


def test_remat_gradients_equal_the_plain_ones_bit_for_bit():
    """remat=True recomputes the forward in the backward; with a Dropout
    between the LSTMs, the recompute must draw the forward's mask (the
    generator replay of nn.composite.Remat)."""
    model = _torch_model(dropout=0.3)
    tp, _ = model.init(0, TNM.ShapeSpec((B, T), torch.int32), device="cpu")
    (x, y), = _batches(1, seed=5)
    got = []
    for remat in (False, True):
        opt = _grad_keeping(False)
        step = TT.make_train_step(model, _tloss, opt, donate=False,
                                  remat=remat)
        gen = torch.Generator().manual_seed(7)
        st, loss, _ = step(TS.TrainState.create(tp, {}, opt), gen,
                           (to_torch(x),), (to_torch(y),))
        got.append((float(loss), st.opt_state, gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = got
    assert l0 == l1
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
    # the generator ends where the forward left it, in both
    assert torch.equal(s0, s1)


def test_check_gradients_in_float64():
    jp, js = _params()
    (x, y), = _batches(1, seed=6)
    # impl="scan": the masked scan under autograd, which computes in the
    # policy's float64; the fused loop's plain versions ("torch") compute
    # in f32 as kernels D and E do
    ttr = TT.Trainer(_torch_model(impl="scan"), _tloss, TO.sgd(),
                     device="cpu")
    tstate = TS.TrainState.create(
        params_from_numpy(jax.device_get(jp), device="cpu"), {}, ttr.optimizer)
    worst = ttr.check_gradients(tstate, (x, y))
    assert worst < 1e-6
    # the policy is restored afterwards
    from paddle_tpu_torch.core import dtypes as TD
    assert TD.default_policy().compute_dtype == torch.float32


class _ScaledBackward(torch.autograd.Function):
    """Identity forward, backward scaled by 1.5: a wrong gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return 1.5 * g


def test_check_gradients_finds_a_wrong_backward():
    model = TNM.Sequential([
        TNL.Dense(6, name="fc1", activation="tanh"),
        TNL.Lambda(_ScaledBackward.apply, name="wrong"),
        TNL.Dense(3, name="fc2")])
    ttr = TT.Trainer(model, _tloss, TO.sgd(), device="cpu")
    state = ttr.init_state(TNM.ShapeSpec((4, 5)))
    rs = np.random.RandomState(0)
    batch = (rs.standard_normal((4, 5)).astype(np.float32),
             rs.randint(0, 3, 4).astype(np.int64))
    assert ttr.check_gradients(state, batch) > 0.1


def test_a_kernel_path_given_float64_raises():
    """The time-loop kernels take f32 and bf16: the kernel path refuses
    float64 (on the card check_gradients of a model on impl None raises
    there); the dtype check comes before the device check, so it shows
    on the CPU too."""
    layer = TNR.LSTM(HID, impl="kernel")
    params, _ = layer.init(0, TNM.ShapeSpec((2, 3, 4)), device="cpu")
    x = torch.zeros((2, 3, 4), dtype=torch.float64)
    p64 = {k: v.double() for k, v in params.items()}
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        layer.apply(p64, {}, x, training=True)
    ttr = TT.Trainer(_torch_model(impl="kernel"), _tloss, TO.sgd(),
                     device="cpu")
    tp, _ = _torch_model().init(0, TNM.ShapeSpec((B, T), torch.int32),
                                device="cpu")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ttr.check_gradients(TS.TrainState.create(tp, {}, ttr.optimizer),
                            _batches(1)[0])


def test_parameter_stats_match_jax(capsys):
    jp, _ = _params()
    host = jax.device_get(jp)
    want = JP.parameter_stats(host, grads=host)
    got = TP.parameter_stats(params_from_numpy(host, device="cpu"),
                             grads=params_from_numpy(host, device="cpu"))
    assert got == want
    assert TP.format_parameter_stats(got) == JP.format_parameter_stats(want)


def test_train_checkpoint_cadence_matches_jax(tmp_path):
    jp, js = _params()
    host = jax.device_get(jp)    # before JAX's step donates jp
    train = _batches(5, seed=7)
    jtr = JT.Trainer(_jax_model(), _jloss, JO.sgd(0.1))
    ttr = TT.Trainer(_torch_model(), _tloss, TO.sgd(0.1), device="cpu")
    tstate = TS.TrainState.create(params_from_numpy(host, device="cpu"), {},
                                  ttr.optimizer)
    jm = JC.CheckpointManager(str(tmp_path / "jax"), max_to_keep=None)
    tm = TC.CheckpointManager(str(tmp_path / "torch"), max_to_keep=None)
    jtr.train(JS.TrainState.create(jp, js, jtr.optimizer),
              lambda: [(to_jax(x), to_jax(y)) for x, y in train],
              num_passes=2, checkpoint_manager=jm,
              checkpoint_every_n_batches=2)
    out = ttr.train(tstate, lambda: train, num_passes=2,
                    checkpoint_manager=tm, checkpoint_every_n_batches=2,
                    parameter_stats_period=4)
    assert tm.all_steps() == sorted(jm.all_steps()) == [2, 4, 5, 7, 9, 10]
    restored = tm.restore(TS.TrainState.create(
        params_from_numpy(host, device="cpu"), {}, ttr.optimizer))
    for a, b in zip(tree_leaves(restored.params), tree_leaves(out.params)):
        assert torch.equal(a, b)


def test_train_prints_parameter_stats_every_period(capsys):
    ttr = TT.Trainer(_torch_model(), _tloss, TO.sgd(0.1), device="cpu")
    state = ttr.init_state(TNM.ShapeSpec((B, T), torch.int32))
    ttr.train(state, lambda: _batches(4, seed=8), parameter_stats_period=2)
    out = capsys.readouterr().out
    assert out.count("--- parameter stats") == 2
    assert "pass 0 batch 1" in out and "pass 0 batch 3" in out
    assert "emb/table" in out


def test_evaluate_with_evaluators_matches_jax():
    jp, js = _params()
    test = _batches(3, seed=9)
    jtr = JT.Trainer(_jax_model(), _jloss, JO.sgd())
    ttr = TT.Trainer(_torch_model(), _tloss, TO.sgd(), device="cpu")
    tstate = TS.TrainState.create(
        params_from_numpy(jax.device_get(jp), device="cpu"), {},
        ttr.optimizer)
    jev = [JM.ClassificationErrorEvaluator(), JM.PrecisionRecallEvaluator(2),
           JM.ClassificationErrorEvaluator(), JM.SumEvaluator()]
    tev = [TM.ClassificationErrorEvaluator(), TM.PrecisionRecallEvaluator(2),
           TM.ClassificationErrorEvaluator(), TM.SumEvaluator()]
    jres = jtr.evaluate(JS.TrainState.create(jp, js, jtr.optimizer),
                        lambda: [(to_jax(x), to_jax(y)) for x, y in test],
                        evaluators=jev)
    tres = ttr.evaluate(tstate, lambda: test, evaluators=tev)
    assert abs(tres.cost - jres.cost) <= 1e-5
    assert sorted(tres.metrics) == sorted(jres.metrics) == [
        "classification_error", "classification_error#1",
        "precision_recall/f1", "precision_recall/precision",
        "precision_recall/recall", "sum"]
    for k in ("classification_error", "classification_error#1",
              "precision_recall/f1"):
        assert tres.metrics[k] == jres.metrics[k]
    assert abs(tres.metrics["sum"] - jres.metrics["sum"]) <= 1e-4
