"""The port's image models against the JAX package's: eval and train
forwards, first-step gradients and the BN state after one step for
resnet (18, 50, the s2d stem and both remat variants), resnet_cifar,
smallnet, lenet, mlp, vgg, alexnet and googlenet; three momentum steps
of resnet50 under `make_train_step(donate=True)` against JAX's own step;
what the remat variants recompute; GoogLeNet's fused inception block
against its plain branches.

The weights are drawn once per case from a seed (by the port's
initializers: their trees are the JAX initializer's, checked through
`jax.eval_shape`) and handed to both sides as numpy (JAX) and through
`params_from_numpy` (the port). Tolerances: logits
and loss 1e-4 (max abs error over max |JAX|), every gradient and state
leaf 1e-4 on its own scale floored as `torch_parity.tree_rel_errs`
floors it; 2e-2 under the bf16 policy.

Training steps are compared in float64 on both sides (an f64 policy,
the same weights cast up). At these widths a training step in f32 is
ill-conditioned: on random images the batch statistics of the deep BNs
(a few values per channel, features nearly alike across images) cancel
in E[x^2] - E[x]^2, so rounding alone moves a deep leaf's f32 gradient
by a large fraction of its size against a float64 run, in JAX and in
the port alike. In f64 the two packages
agree far inside 1e-4, which holds the semantics; the f32 step is held
against that float64 truth beside JAX's f32 step
(`test_f32_training_step_is_as_accurate_as_jaxs`). Eval forwards (the
running statistics) are well conditioned and compare in f32."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu import models as JM
from paddle_tpu import optim as JO
from paddle_tpu.core import dtypes as JD
from paddle_tpu.nn.module import ShapeSpec as JSpec
from paddle_tpu.nn.module import merge_state as jax_merge_state
from paddle_tpu.ops import losses as JL
from paddle_tpu.train import state as JS
from paddle_tpu.train import trainer as JT
from paddle_tpu_torch.core import dtypes as TD
from paddle_tpu_torch.core.pytree import tree_leaves
from paddle_tpu_torch.models import (alexnet, googlenet, lenet, resnet,
                                     smallnet, vgg)
from paddle_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from paddle_tpu_torch.nn.module import ShapeSpec, merge_state
from paddle_tpu_torch.ops import losses as TL
from paddle_tpu_torch.optim import optimizers as TO
from paddle_tpu_torch.train import state as TS
from paddle_tpu_torch.train import trainer as TT
from torch_parity import (assert_tree_close, named_leaves, rel_err,
                          tree_rel_errs)

TM = dict(resnet=resnet, lenet=lenet, smallnet=smallnet, vgg=vgg,
          alexnet=alexnet, googlenet=googlenet)

# name: (builder over a models namespace, input shape, classes)
CASES = {
    "resnet18": (lambda m: m["resnet"].resnet(18, width=8),
                 (4, 32, 32, 3), 1000),
    "resnet50": (lambda m: m["resnet"].resnet(50, width=8, num_classes=10),
                 (4, 32, 32, 3), 10),
    "resnet_cifar": (lambda m: m["resnet"].resnet_cifar(), (4, 16, 16, 3),
                     10),
    "smallnet": (lambda m: m["smallnet"].smallnet(), (2, 32, 32, 3), 10),
    "lenet": (lambda m: m["lenet"].lenet(), (2, 28, 28, 1), 10),
    "lenet_bn": (lambda m: m["lenet"].lenet(with_bn=True), (2, 28, 28, 1),
                 10),
    "mlp": (lambda m: m["lenet"].mlp(), (2, 28, 28, 1), 10),
    "vgg11": (lambda m: m["vgg"].vgg(11, fc_dim=64, dropout=0.0),
              (2, 32, 32, 3), 1000),
    "alexnet": (lambda m: m["alexnet"].alexnet(num_classes=4, dropout=0.0),
                (2, 67, 67, 3), 4),
    "googlenet": (lambda m: m["googlenet"].googlenet(num_classes=6,
                                                      dropout=0.0),
                  (2, 64, 64, 3), 6),
}
# resnet50's variants: the same trees, so they run on resnet50's weights
VARIANTS = {
    "resnet50_s2d": dict(s2d_stem=True),
    "resnet50_remat": dict(remat="conv_out"),
    "resnet50_remat_full": dict(remat="full"),
}
TOL, BF16_TOL = 1e-4, 2e-2


def _jmodels():
    return {k: getattr(JM, k) for k in TM}


def _models(name):
    """(jax model, torch model, weights case, input shape, classes)."""
    if name in VARIANTS:
        kw = VARIANTS[name]
        return (JM.resnet.resnet(50, width=8, num_classes=10, **kw),
                resnet.resnet(50, width=8, num_classes=10, **kw),
                "resnet50") + CASES["resnet50"][1:]
    build, shape, classes = CASES[name]
    return build(_jmodels()), build(TM), name, shape, classes


@functools.lru_cache(maxsize=None)
def _weights(case):
    """Seeded weights and BN state for a case as f32 numpy trees, drawn
    by the port's initializers (the JAX initializer's jit takes ~20 s at
    these depths); their trees are the JAX initializer's
    (`test_param_and_state_trees_match_jaxs_init`)."""
    build, shape, _ = CASES[case]
    params, state = build(TM).init(0, ShapeSpec(shape), device="cpu")
    return params_to_numpy(params), params_to_numpy(state)


@pytest.mark.parametrize("name", sorted(CASES))
def test_param_and_state_trees_match_jaxs_init(name):
    build, shape, _ = CASES[name]
    jtrees = jax.eval_shape(lambda k: build(_jmodels()).init(k, JSpec(shape)),
                            jax.random.key(0))
    shapes = lambda t: {k: v.shape for k, v in named_leaves(t).items()}
    for jt, tt in zip(jtrees, _weights(name)):
        assert shapes(tt) == {k: tuple(v.shape) for k, v in
                              _named_specs(jt).items()}


def _named_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named_specs(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _batch(shape, classes, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(*shape).astype(np.float32)
    y = np.random.RandomState(seed + 1).randint(0, classes, shape[0])
    return x, y


def _jax_ce(logits, labels):
    return jnp.mean(JL.softmax_cross_entropy(logits, labels))


def _torch_ce(logits, labels):
    return torch.mean(TL.softmax_cross_entropy(logits, labels))


def _jax_train(jmodel, params, state, x, y):
    """(loss, train logits, new state, grads) of one JAX forward and
    backward."""

    def loss(p):
        out, new_state = jmodel.apply(p, state, x, training=True)
        return _jax_ce(out, y), (out, new_state)

    (l, (out, new_state)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return l, out, new_state, grads


def _torch_train(tmodel, params, state, x, y):
    loss, new_state, grads, metrics = TT.loss_and_grads(
        tmodel, _torch_ce, params, state, None, (x,), (y,),
        metrics_fn=lambda out, _: {"logits": out})
    return loss, metrics["logits"], new_state, grads


def _both(name, dtype=np.float32):
    """Both models, the weights, state and batch in `dtype` (jax side,
    torch side)."""
    jmodel, tmodel, case, shape, classes = _models(name)
    jp, js = (jax.tree.map(lambda a: np.asarray(a, dtype), t)
              for t in _weights(case))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tp = params_from_numpy(jp, device="cpu", dtype=tdt)
    ts = params_from_numpy(js, device="cpu", dtype=tdt)
    x, y = _batch(shape, classes)
    x = x.astype(dtype)
    return (jmodel, jp, js, jnp.asarray(x), jnp.asarray(y),
            tmodel, tp, ts, torch.from_numpy(x), torch.from_numpy(y))


@contextlib.contextmanager
def _policies(jpolicy, tpolicy):
    jprev, tprev = JD.default_policy(), TD.default_policy()
    JD.set_default_policy(jpolicy)
    TD.set_default_policy(tpolicy)
    try:
        yield
    finally:
        JD.set_default_policy(jprev)
        TD.set_default_policy(tprev)


def _f64():
    return _policies(JD.Policy(jnp.float64, jnp.float64, jnp.float64),
                     TD.Policy(torch.float64, torch.float64, torch.float64))


@functools.lru_cache(maxsize=None)
def _jax_step_f64(name):
    """JAX's float64 training forward and backward for a case, as numpy:
    (loss, logits, merged new state, grads)."""
    jmodel, jp, js, jx, jy = _both(name, np.float64)[:5]
    with _f64():
        l, out, new_state, grads = _jax_train(jmodel, jp, js, jx, jy)
    npy = lambda t: jax.tree.map(np.asarray, t)
    return (float(l), np.asarray(out), npy(jax_merge_state(js, new_state)),
            npy(grads))


@pytest.mark.parametrize("name", sorted(CASES) + sorted(VARIANTS))
def test_eval_logits_match_jax(name):
    jmodel, jp, js, jx, _, tmodel, tp, ts, tx, _ = _both(name)
    jout = jax.jit(lambda p, s, x: jmodel.apply(p, s, x,
                                                training=False)[0])(jp, js, jx)
    with torch.no_grad():
        tout, new_state = tmodel.apply(tp, ts, tx, training=False)
    assert tuple(tout.shape) == tuple(jout.shape)
    assert rel_err(tout, np.asarray(jout, np.float64)) <= TOL
    # eval passes the running stats through unchanged
    assert_tree_close(merge_state(ts, new_state), js, 0.0)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(VARIANTS))
def test_train_forward_gradients_and_bn_state_match_jax(name):
    # resnet50's variants are held against JAX's plain resnet50 step: the
    # JAX package's own tests hold its variants equal to the plain net
    # (tests/test_models_image.py: test_resnet_s2d_stem_equivalent,
    # test_resnet_remat_equivalent), and compiling each again in f64 costs
    # ~10 s a test
    jl, jout, jstate, jgrads = _jax_step_f64(
        "resnet50" if name in VARIANTS else name)
    _, _, _, _, _, tmodel, tp, ts, tx, ty = _both(name, np.float64)
    with _f64():
        tl, tout, tstate, tgrads = _torch_train(tmodel, tp, ts, tx, ty)
    assert tout.dtype == torch.float64
    assert rel_err(tout, jout) <= TOL
    assert abs(float(tl) - jl) <= TOL * abs(jl)
    assert_tree_close(tgrads, jgrads, TOL)
    assert_tree_close(merge_state(ts, tstate), jstate, TOL)


@pytest.mark.parametrize("name", ["resnet50", "resnet18", "lenet_bn"])
def test_f32_training_step_is_as_accurate_as_jaxs(name):
    """The port's f32 gradients and BN state stand no further from the
    float64 truth than twice JAX's f32 ones (plus 1e-4), leaf by leaf
    (the largest error over the tree)."""
    _, _, truth_state, truth_grads = _jax_step_f64(name)
    jmodel, jp, js, jx, jy, tmodel, tp, ts, tx, ty = _both(name)
    _, _, jstate, jgrads = _jax_train(jmodel, jp, js, jx, jy)
    _, _, tstate, tgrads = _torch_train(tmodel, tp, ts, tx, ty)
    worst = lambda got, want: max(tree_rel_errs(got, want).values())
    assert worst(tgrads, truth_grads) <= (
        2 * worst(jax.tree.map(np.asarray, jgrads), truth_grads) + TOL)
    assert worst(merge_state(ts, tstate), truth_state) <= (
        2 * worst(jax.tree.map(np.asarray, jax_merge_state(js, jstate)),
                  truth_state) + TOL)


def test_resnet18_eval_under_the_bf16_policy_matches_jax():
    jmodel, jp, js, jx, _, tmodel, tp, ts, tx, _ = _both("resnet18")
    with _policies(JD.bf16_compute_policy(), TD.bf16_compute_policy()):
        jout = jax.jit(lambda p, s, x: jmodel.apply(
            p, s, x, training=False)[0])(jp, js, jx)
        with torch.no_grad():
            tout, _ = tmodel.apply(tp, ts, tx, training=False)
    assert tout.dtype == torch.float32  # the logits' f32 bias promotes
    assert rel_err(tout, np.asarray(jout, np.float64)) <= BF16_TOL


def test_three_momentum_steps_of_resnet50_match_jaxs_step():
    """make_train_step(donate=True) with momentum(0.1, mu=0.9) and
    softmax CE, three steps on one batch, against JAX's jitted step (in
    float64, see the module docstring)."""
    jmodel, jp, js, jx, jy, tmodel, tp, ts, tx, ty = _both("resnet50",
                                                          np.float64)
    # the port's state is bridged before the JAX step, which donates its
    # state
    topt = TO.momentum(0.1, mu=0.9)
    tstate = TS.TrainState.create(tp, ts, topt)
    jopt = JO.momentum(0.1, mu=0.9)
    jstate = JS.TrainState.create(jax.tree.map(jnp.asarray, jp),
                                  jax.tree.map(jnp.asarray, js), jopt)
    jstep = JT.make_train_step(jmodel, _jax_ce, jopt, donate=True)
    tstep = TT.make_train_step(tmodel, _torch_ce, topt, donate=True)
    jlosses, tlosses = [], []
    with _f64():
        for _ in range(3):
            jstate, jl, _ = jstep(jstate, jax.random.key(0), (jx,), (jy,))
            tstate, tl, _ = tstep(tstate, None, (tx,), (ty,))
            jlosses.append(float(jl))
            tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)
    assert_tree_close(tstate.params, jstate.params, TOL)
    assert_tree_close(tstate.model_state, jstate.model_state, TOL)
    assert int(tstate.step) == 3


class _CountConvs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func == torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _conv_counts(remat):
    """(convolutions in the forward, convolutions the backward runs) of
    one resnet50 training step."""
    tmodel = resnet.resnet(50, width=8, num_classes=10, remat=remat)
    tp = params_from_numpy(_weights("resnet50")[0], device="cpu")
    ts = params_from_numpy(_weights("resnet50")[1], device="cpu")
    x, y = (torch.from_numpy(a) for a in _batch((2, 32, 32, 3), 10))
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    with _CountConvs() as fwd:
        out, _ = tmodel.apply(tp, ts, x, training=True)
        loss = _torch_ce(out, y)
    with _CountConvs() as bwd:
        torch.autograd.grad(loss, leaves)
    return fwd.n, bwd.n


def test_remat_conv_out_recomputes_no_convolution_and_full_every_one():
    # resnet50: the stem, 16 blocks of 3 convs and 4 projection shortcuts
    in_blocks = 16 * 3 + 4
    assert _conv_counts(None) == (1 + in_blocks, 0)
    assert _conv_counts("conv_out") == (1 + in_blocks, 0)
    assert _conv_counts("full") == (1 + in_blocks, in_blocks)


@pytest.mark.parametrize("remat", ["conv_out", "full"])
def test_remat_step_equals_the_plain_step(remat):
    """The same gradients, and the BN running stats updated once, as by a
    plain step (the recompute's copy of the new state is dropped)."""
    plain = resnet.resnet(50, width=8, num_classes=10)
    wrapped = resnet.resnet(50, width=8, num_classes=10, remat=remat)
    x, y = (torch.from_numpy(a) for a in _batch((2, 32, 32, 3), 10))
    results = []
    for model in (plain, wrapped):
        tp = params_from_numpy(_weights("resnet50")[0], device="cpu")
        ts = params_from_numpy(_weights("resnet50")[1], device="cpu")
        opt = TO.momentum(0.1, mu=0.9)
        state = TS.TrainState.create(tp, ts, opt)
        step = TT.make_train_step(model, _torch_ce, opt)
        state, loss, _ = step(state, None, (x,), (y,))
        results.append((loss, state))
    (l0, s0), (l1, s1) = results
    assert torch.equal(l0, l1)
    assert_tree_close(s1.model_state, s0.model_state, 0.0)
    assert_tree_close(s1.params, s0.params, 1e-6)


def test_fused_inception_equals_its_plain_branches():
    from paddle_tpu_torch.models.googlenet import (Inception,
                                                   _inception_branches)
    sizes = (8, 6, 10, 4, 6, 5)
    spec = ShapeSpec((2, 9, 9, 7))
    fused = Inception(*sizes, name="i")
    plain = _inception_branches("i", *sizes)
    params, _ = fused.init(0, spec, device="cpu")
    x = torch.randn(2, 9, 9, 7)
    a, _ = fused.apply(params, {}, x)
    b, _ = plain.apply(params, {}, x)
    assert a.shape == b.shape == (2, 9, 9, 8 + 10 + 6 + 5)
    assert rel_err(a, b.numpy()) <= 1e-6


def test_trainer_train_runs_the_train_step():
    """Trainer.train (bench_trainer_loop's path) over two batches leaves
    the same state as two calls of make_train_step."""
    tmodel = resnet.resnet(18, width=8, num_classes=10)
    x, y = _batch((2, 32, 32, 3), 10)
    opt = TO.momentum(0.1, mu=0.9)
    trainer = TT.Trainer(tmodel, _torch_ce, opt, device="cpu")
    state0 = trainer.init_state(ShapeSpec((2, 32, 32, 3)))
    copy = lambda t: {k: copy(v) if isinstance(v, dict) else v.clone()
                      for k, v in t.items()}
    by_hand = TS.TrainState.create(copy(state0.params),
                                   copy(state0.model_state), opt)
    costs = []
    state = trainer.train(
        state0, lambda: iter([(x, y), (x, y)]),
        event_handler=lambda ev: costs.append(getattr(ev, "cost", None)))
    step = TT.make_train_step(tmodel, _torch_ce, opt, donate=True)
    for _ in range(2):
        by_hand, _, _ = step(by_hand, None, (torch.from_numpy(x),),
                             (torch.from_numpy(y),))
    assert_tree_close(state.params, by_hand.params, 0.0)
    assert_tree_close(state.model_state, by_hand.model_state, 0.0)
    assert len([c for c in costs if c is not None]) == 2


def test_trainer_draws_dropout_masks_from_a_generator_on_its_device():
    """A Trainer's steps get a generator on its device, seeded by `seed`
    (the parameters come from a separate CPU generator with the same
    seed): two Trainer.train steps of a dropout net equal two
    make_train_step calls given such a generator."""
    tmodel = vgg.vgg(11, fc_dim=64, dropout=0.5)
    x, y = _batch((2, 32, 32, 3), 10)
    opt = TO.momentum(0.01, mu=0.9)
    trainer = TT.Trainer(tmodel, _torch_ce, opt, seed=3, device="cpu")
    assert trainer._rng.device == trainer.device
    state0 = trainer.init_state(ShapeSpec((2, 32, 32, 3)))
    init = lambda: tmodel.init(torch.Generator().manual_seed(3),
                               ShapeSpec((2, 32, 32, 3)), device="cpu")
    params, mstate = init()
    assert_tree_close(state0.params, params, 0.0)
    by_hand = TS.TrainState.create(params, mstate, opt)
    state = trainer.train(state0, lambda: iter([(x, y), (x, y)]))
    step = TT.make_train_step(tmodel, _torch_ce, opt)
    gen = torch.Generator(device="cpu").manual_seed(3)
    for _ in range(2):
        by_hand, _, _ = step(by_hand, gen, (torch.from_numpy(x),),
                             (torch.from_numpy(y),))
    assert_tree_close(state.params, by_hand.params, 0.0)
    # the masks were drawn: the same step without dropout differs
    plain = TT.make_train_step(vgg.vgg(11, fc_dim=64, dropout=0.0),
                               _torch_ce, opt)
    no_drop = TS.TrainState.create(*init(), opt)
    for _ in range(2):
        no_drop, _, _ = plain(no_drop, None, (torch.from_numpy(x),),
                              (torch.from_numpy(y),))
    assert max(tree_rel_errs(no_drop.params, state.params).values()) > 1e-3


@pytest.mark.parametrize("policy", [None, "conv_out"])
def test_remat_replays_the_forwards_dropout_mask(policy):
    """Remat's recompute draws the forward's Dropout mask again (the
    generator is rewound for it and put back after): the gradients and
    the generator's next state equal the plain layer's."""
    from paddle_tpu_torch.nn import composite as TCM
    from paddle_tpu_torch.nn import layers as TNL
    from paddle_tpu_torch.nn.module import Sequential

    inner = Sequential([TNL.Dense(32, activation="relu", name="a"),
                        TNL.Dropout(0.5), TNL.Dense(4, name="b")],
                       name="blk")
    wrapped = TCM.Remat(inner, policy=policy)
    params, _ = inner.init(0, ShapeSpec((8, 16)), device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 16)
                         .astype(np.float32))
    results = []
    for model in (inner, wrapped):
        p = {k: {n: t.clone().requires_grad_() for n, t in v.items()}
             for k, v in params.items()}
        gen = torch.Generator().manual_seed(5)
        out, _ = model.apply(p, {}, x, training=True, rng=gen)
        grads = torch.autograd.grad((out ** 2).sum(), tree_leaves(p))
        results.append((out.detach(), grads, torch.rand(3, generator=gen)))
    (o0, g0, n0), (o1, g1, n1) = results
    assert torch.equal(o0, o1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert torch.equal(n0, n1)


# (builder over a models namespace, input shape) at bench_image's 1000
# classes, without dropout
DIVERGING = {
    "alexnet": (lambda m: m["alexnet"].alexnet(num_classes=1000,
                                                dropout=0.0), (2, 67, 67, 3)),
    "googlenet": (lambda m: m["googlenet"].googlenet(num_classes=1000,
                                                      dropout=0.0),
                  (2, 64, 64, 3)),
}


@pytest.fixture
def one_torch_thread():
    """torch on one thread: a conv net's CPU steps slow down ~30x when
    several test processes share the cores with torch's full pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(DIVERGING))
def test_bench_recipe_diverges_alike_in_jax_and_the_port(name,
                                                         one_torch_thread):
    """bench_image's recipe -- momentum(0.1, mu=0.9), softmax CE, one batch
    repeated -- diverges for AlexNet and GoogLeNet in the JAX package as
    in the port (why the smoke's timed runs train at lr 0.01): 6 steps
    from the same weights on each side; the losses agree step by step
    (1e-3) while JAX's stays under 10x the first, and both runs end past
    10x the first loss or non-finite."""
    build, shape = DIVERGING[name]
    tmodel, jmodel = build(TM), build(_jmodels())
    tp, ts = tmodel.init(torch.Generator().manual_seed(0), ShapeSpec(shape),
                         device="cpu")
    # copies: the port's step updates its tensors (and their numpy views)
    # in place
    jp, js = (jax.tree.map(np.array, params_to_numpy(t)) for t in (tp, ts))
    x, y = _batch(shape, 1000)
    topt, jopt = TO.momentum(0.1, mu=0.9), JO.momentum(0.1, mu=0.9)
    tstate = TS.TrainState.create(tp, ts, topt)
    # one compile for the state, and JAX's step compiled without LLVM's
    # costly passes: the same program, a fraction of the compile time
    jstate = jax.jit(lambda p, s: JS.TrainState.create(p, s, jopt))(jp, js)
    jargs = (jax.random.key(0), (jnp.asarray(x),), (jnp.asarray(y),))
    jstep = JT.make_train_step(jmodel, _jax_ce, jopt, donate=True).lower(
        jstate, *jargs).compile(compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True})
    tstep = TT.make_train_step(tmodel, _torch_ce, topt, donate=True)
    tlosses, jlosses = [], []
    for _ in range(6):
        tstate, tl, _ = tstep(tstate, None, (torch.from_numpy(x),),
                              (torch.from_numpy(y),))
        jstate, jl, _ = jstep(jstate, *jargs)
        tlosses.append(float(tl))
        jlosses.append(float(jl))
    first = jlosses[0]
    for t, j in zip(tlosses, jlosses):
        if not (np.isfinite(j) and j < 10 * first):
            break
        assert abs(t - j) <= 1e-3 * abs(j), (tlosses, jlosses)
    for losses in (tlosses, jlosses):
        assert not (np.isfinite(losses[-1]) and losses[-1] < 10 * first), (
            tlosses, jlosses)
