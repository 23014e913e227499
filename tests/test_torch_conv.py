"""The port's image ops against the JAX package's, forward and vjp on the
same seeded inputs: `ops.conv` (conv2d at every padding form, strides,
groups, dilation and the bf16 policy; the space-to-depth conv; the
pools, with the max pool's tie rule), `ops.norm` batch_norm and lrn,
every activation of `ops.activations.get`'s table, the initializers and
the image layers' shape inference.

Tolerances: max abs error over max |JAX| within 1e-5 in f32, 2e-2 under
bf16; the max pool's gradient at ties exactly equal."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core import dtypes as JD
from paddle_tpu.nn import initializers as JI
from paddle_tpu.ops import activations as JA
from paddle_tpu.ops import conv as JC
from paddle_tpu.ops import norm as JN
from paddle_tpu_torch.core import dtypes as TD
from paddle_tpu_torch.nn import initializers as TI
from paddle_tpu_torch.nn import layers as TNL
from paddle_tpu_torch.nn.module import ShapeSpec
from paddle_tpu_torch.ops import activations as TA
from paddle_tpu_torch.ops import conv as TC
from paddle_tpu_torch.ops import norm as TN
from torch_parity import np_f32, rel_err

F32_TOL, BF16_TOL = 1e-5, 2e-2


@pytest.fixture
def bf16_policy():
    jprev, tprev = JD.default_policy(), TD.default_policy()
    JD.set_default_policy(JD.bf16_compute_policy())
    TD.set_default_policy(TD.bf16_compute_policy())
    try:
        yield
    finally:
        JD.set_default_policy(jprev)
        TD.set_default_policy(tprev)


def _vjp_pair(jfn, tfn, args, cot_seed=1):
    """Forward of both on the same numpy args, then each one's vjp with
    the same seeded cotangent: (jax out, torch out, jax grads, torch
    grads)."""
    jargs = [jnp.asarray(a) for a in args]
    jout, jvjp = jax.vjp(jfn, *jargs)
    targs = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    tout = tfn(*targs)
    cot = np_f32(np.random.RandomState(cot_seed), *jout.shape)
    jgrads = jvjp(jnp.asarray(cot).astype(jout.dtype))
    tgrads = torch.autograd.grad(
        tout, targs, torch.from_numpy(cot).to(tout.dtype))
    return jout, tout, jgrads, tgrads


def _check(jout, tout, jgrads, tgrads, tol):
    assert tuple(tout.shape) == tuple(jout.shape)
    assert rel_err(tout, np.asarray(jout, np.float64)) <= tol
    for jg, tg in zip(jgrads, tgrads):
        assert rel_err(tg, np.asarray(jg, np.float64)) <= tol


# -- padding arithmetic ---------------------------------------------------------


@pytest.mark.parametrize("h,window,stride,padding,dilation", [
    (224, 7, 2, "SAME", 1), (112, 3, 2, "SAME", 1), (56, 3, 2, "SAME", 1),
    (9, 4, 1, "SAME", 1), (8, 3, 1, "SAME", 2), (67, 11, 4, "VALID", 1),
    (32, 3, 2, 1, 1), (10, 3, 1, ((1, 0), (2, 1)), 1),
])
def test_padding_arithmetic_is_the_jax_packages(h, window, stride, padding,
                                                dilation):
    args = (h, h + 1, window, stride, padding, dilation)
    assert TC.explicit_pad(*args) == JC.explicit_pad(*args)
    assert TC.out_hw(*args) == JC.out_hw(*args)


def test_same_padding_is_asymmetric_where_the_total_is_odd():
    # ResNet-50 at 224: the 7x7/s2 stem pads (2, 3), a 3x3/s2 conv (0, 1)
    assert TC.explicit_pad(224, 224, 7, 2, "SAME") == ((2, 3), (2, 3))
    assert TC.explicit_pad(56, 56, 3, 2, "SAME") == ((0, 1), (0, 1))


# -- conv2d -----------------------------------------------------------------------

CONV_CASES = {
    # name: (h, w, cin, cout, k, stride, padding, dilation, groups, bias)
    "same_s1_even": (8, 8, 3, 5, 3, 1, "SAME", 1, 1, True),
    "same_s1_k4_asym": (9, 9, 3, 4, 4, 1, "SAME", 1, 1, False),
    "same_s2_even_asym": (8, 8, 3, 4, 3, 2, "SAME", 1, 1, False),
    "same_s2_odd": (9, 7, 3, 4, 3, 2, "SAME", 1, 1, True),
    "stem_7x7_s2_asym": (16, 16, 3, 8, 7, 2, "SAME", 1, 1, False),
    "stem_7x7_s2_odd": (15, 15, 3, 8, 7, 2, "SAME", 1, 1, False),
    "valid_s4": (19, 19, 3, 6, 11, 4, "VALID", 1, 1, True),
    "int_padding": (8, 8, 4, 4, 5, 1, 2, 1, 1, True),
    "explicit_pads": (7, 8, 3, 4, 3, 1, ((1, 0), (2, 1)), 1, 1, True),
    "groups2": (8, 8, 4, 6, 3, 1, "SAME", 1, 2, True),
    "dilation2": (9, 9, 3, 4, 3, 1, "SAME", 2, 1, False),
    "pointwise": (6, 6, 8, 16, 1, 1, "SAME", 1, 1, True),
}


def _conv_args(case, seed=0):
    h, w, cin, cout, k, stride, padding, dilation, groups, bias = case
    rs = np.random.RandomState(seed)
    args = [np_f32(rs, 2, h, w, cin), np_f32(rs, k, k, cin // groups, cout)]
    if bias:
        args.append(np_f32(rs, cout))
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups)
    return args, kw


def _conv_fns(kw):
    def jfn(x, k, b=None):
        return JC.conv2d(x, k, bias=b, **kw)

    def tfn(x, k, b=None):
        return TC.conv2d(x, k, bias=b, **kw)

    return jfn, tfn


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv2d_forward_and_vjp_match_jax(name):
    args, kw = _conv_args(CONV_CASES[name])
    _check(*_vjp_pair(*_conv_fns(kw), args), F32_TOL)


@pytest.mark.parametrize("name", ["same_s2_even_asym", "stem_7x7_s2_asym",
                                  "groups2", "same_s1_even"])
def test_conv2d_under_the_bf16_policy_matches_jax(name, bf16_policy):
    args, kw = _conv_args(CONV_CASES[name])
    jout, tout, jg, tg = _vjp_pair(*_conv_fns(kw), args)
    # an f32 bias promotes the bf16 product to f32 in both packages
    has_bias = len(args) == 3
    assert str(jout.dtype) == ("float32" if has_bias else "bfloat16")
    assert tout.dtype == (torch.float32 if has_bias else torch.bfloat16)
    _check(jout, tout, jg, tg, BF16_TOL)


@pytest.mark.parametrize("on_card", [True, False], ids=["cuda", "cpu"])
def test_conv2d_operand_layouts(on_card, monkeypatch):
    """On the card the NHWC input reaches F.conv2d as a channels_last
    NCHW view (no layout copy), the weight likewise; CPU tensors go NCHW
    contiguous (torch's CPU backward of a 1x1 stride-2 conv over
    channels_last memory corrupts the heap). On the card the output is a
    contiguous NHWC tensor."""
    seen = []
    real = torch.nn.functional.conv2d

    def spy(x, w, *a, **k):
        seen.append(tuple(t.is_contiguous(memory_format=f) for t in (x, w)
                          for f in (torch.channels_last,
                                    torch.contiguous_format)))
        return real(x, w, *a, **k)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    if on_card:
        monkeypatch.setattr(torch.Tensor, "is_cuda",
                            property(lambda t: True))
    y = TC.conv2d(torch.randn(2, 8, 8, 3), torch.randn(3, 3, 3, 4))
    assert seen == [(True, False, True, False) if on_card
                    else (False, True, False, True)]
    assert tuple(y.shape) == (2, 8, 8, 4)
    assert y.is_contiguous() == on_card


def test_conv2d_1x1_stride2_backward_runs_on_the_cpu():
    """The projection shortcut's shape, which crashed torch's CPU
    backward on channels_last operands."""
    x = torch.randn(4, 16, 16, 8, requires_grad=True)
    k = torch.randn(1, 1, 8, 16, requires_grad=True)
    for _ in range(20):
        y = TC.conv2d(x, k, stride=2)
        gx, gk = torch.autograd.grad(y.sum(), [x, k])
    assert gx.shape == x.shape and gk.shape == k.shape


@pytest.mark.parametrize("h,k,padding", [(16, 7, "SAME"), (16, 3, "SAME"),
                                         (15, 7, "SAME"), (16, 4, "VALID"),
                                         (16, 7, 3)])
def test_space_to_depth_conv_matches_the_direct_conv_and_jax(h, k, padding):
    rs = np.random.RandomState(3)
    x, kern = np_f32(rs, 2, h, h, 3), np_f32(rs, k, k, 3, 8)
    kw = dict(stride=2, padding=padding)
    jout, tout, jg, tg = _vjp_pair(
        lambda a, b: JC.conv2d_space_to_depth(a, b, **kw),
        lambda a, b: TC.conv2d_space_to_depth(a, b, **kw), [x, kern])
    _check(jout, tout, jg, tg, F32_TOL)
    direct = TC.conv2d(torch.from_numpy(x), torch.from_numpy(kern), **kw)
    assert rel_err(tout, direct.detach().numpy()) <= F32_TOL


def test_space_to_depth_round_trips():
    x = torch.arange(2 * 4 * 6 * 3, dtype=torch.float32).reshape(2, 4, 6, 3)
    blocked = TC.space_to_depth(x, 2)
    assert tuple(blocked.shape) == (2, 2, 3, 12)
    np.testing.assert_array_equal(
        blocked.numpy(), np.asarray(JC.space_to_depth(jnp.asarray(x.numpy()))))
    assert torch.equal(TC.depth_to_space(blocked, 2), x)
    kern = np_f32(np.random.RandomState(0), 7, 7, 3, 4)
    np.testing.assert_array_equal(
        TC.s2d_kernel(torch.from_numpy(kern), 2).numpy(),
        np.asarray(JC.s2d_kernel(jnp.asarray(kern), 2)))


# -- pools --------------------------------------------------------------------------

POOL_CASES = {
    # name: (h, window, stride, padding)
    "resnet_stem_3x3_s2_same": (12, 3, 2, "SAME"),
    "same_odd": (11, 3, 2, "SAME"),
    "valid_3x3_s2": (13, 3, 2, "VALID"),
    "int_padding_1": (8, 3, 2, 1),
    "window2": (8, 2, None, "VALID"),
    "inception_3x3_s1_pad1": (7, 3, 1, 1),
}


def _relu_input(h, seed=0):
    # post-ReLU: about half the entries are 0, so windows tie often
    return np.maximum(np_f32(np.random.RandomState(seed), 2, h, h, 3), 0)


@pytest.mark.parametrize("tie_split", [False, True], ids=["pick_first",
                                                          "tie_split"])
@pytest.mark.parametrize("name", sorted(POOL_CASES))
def test_max_pool2d_gradient_at_ties_is_exactly_jaxs(name, tie_split):
    h, window, stride, padding = POOL_CASES[name]
    x = _relu_input(h)
    kw = dict(stride=stride, padding=padding, tie_split=tie_split)
    jout, tout, (jg,), (tg,) = _vjp_pair(
        lambda a: JC.max_pool2d(a, window, **kw),
        lambda a: TC.max_pool2d(a, window, **kw), [x])
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    tied = (x == 0).sum()
    assert tied > x.size // 4
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_max_pool2d_pick_first_rule_on_a_probe():
    """A window of equal maxima gives its whole cotangent to the first in
    row-major order; tie_split shares it."""
    x = torch.zeros(1, 2, 2, 1, requires_grad=True)
    for tie_split, want in ((False, [[1.0, 0.0], [0.0, 0.0]]),
                            (True, [[0.25, 0.25], [0.25, 0.25]])):
        y = TC.max_pool2d(x, 2, tie_split=tie_split)
        (g,) = torch.autograd.grad(y.sum(), x)
        np.testing.assert_array_equal(g[0, :, :, 0].numpy(), want)


def test_max_pool2d_reads_the_env_default(monkeypatch):
    x = _relu_input(8, seed=2)
    monkeypatch.setenv("PADDLE_TPU_POOL_TIE_SPLIT", "1")
    _, _, (jg,), (tg,) = _vjp_pair(
        lambda a: JC.max_pool2d(a, 3, stride=2, padding="SAME"),
        lambda a: TC.max_pool2d(a, 3, stride=2, padding="SAME"), [x])
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    split = TC.max_pool2d(torch.zeros(1, 2, 2, 1, requires_grad=True), 2)
    assert split.grad_fn.name().startswith("_MaxPool2dTieSplit")


@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("name", ["resnet_stem_3x3_s2_same", "same_odd",
                                  "valid_3x3_s2", "int_padding_1", "window2"])
def test_avg_pool2d_matches_jax(name, count_include_pad):
    h, window, stride, padding = POOL_CASES[name]
    x = np_f32(np.random.RandomState(4), 2, h, h, 3)
    kw = dict(stride=stride, padding=padding,
              count_include_pad=count_include_pad)
    _check(*_vjp_pair(lambda a: JC.avg_pool2d(a, window, **kw),
                      lambda a: TC.avg_pool2d(a, window, **kw), [x]),
           F32_TOL)


def test_avg_pool2d_pads_before_the_op(monkeypatch):
    """torch's CUDA avg_pool2d backward over channels_last memory is
    wrong whenever the op pads (torch 2.11.0): avg_pool2d applies every
    padding with F.pad and hands the op padding 0."""
    seen = []
    real = torch.nn.functional.avg_pool2d

    def spy(x, *a, padding=0, **k):
        seen.append(padding)
        return real(x, *a, padding=padding, **k)

    monkeypatch.setattr(torch.nn.functional, "avg_pool2d", spy)
    x = torch.randn(2, 8, 8, 3)
    for cip in (True, False):
        TC.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=cip)
    assert seen and all(p == (0, 0) for p in seen)


def test_global_avg_pool2d_matches_jax():
    x = np_f32(np.random.RandomState(5), 2, 5, 7, 4)
    _check(*_vjp_pair(JC.global_avg_pool2d, TC.global_avg_pool2d, [x]),
           F32_TOL)


# -- normalization -------------------------------------------------------------------


@pytest.mark.parametrize("fast_variance", [True, False])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_jax(training, fast_variance):
    rs = np.random.RandomState(6)
    x = np_f32(rs, 4, 5, 6, 8) * 3.0 + 1.5
    scale = 1.0 + 0.1 * np_f32(rs, 8)
    offset = 0.1 * np_f32(rs, 8)
    rmean, rvar = 0.1 * np_f32(rs, 8), 1.0 + np.abs(np_f32(rs, 8))
    kw = dict(training=training, fast_variance=fast_variance)

    def jfn(a, s, o, stats=False):
        y, m, v = JN.batch_norm(a, s, o, jnp.asarray(rmean),
                                jnp.asarray(rvar), **kw)
        return (m, v) if stats else y

    def tfn(a, s, o, stats=False):
        y, m, v = TN.batch_norm(a, s, o, torch.from_numpy(rmean),
                                torch.from_numpy(rvar), **kw)
        return (m, v) if stats else y

    _check(*_vjp_pair(jfn, tfn, [x, scale, offset]), F32_TOL)
    jstats = jfn(*map(jnp.asarray, (x, scale, offset)), stats=True)
    tstats = tfn(*map(torch.from_numpy, (x, scale, offset)), stats=True)
    for jm, tm in zip(jstats, tstats):
        assert rel_err(tm, np.asarray(jm, np.float64)) <= F32_TOL
    if not training:
        assert torch.equal(tstats[0], torch.from_numpy(rmean))


def test_batch_norm_running_stats_follow_jaxs_momentum_convention():
    x = torch.from_numpy(np_f32(np.random.RandomState(7), 3, 4, 4, 2))
    _, m, v = TN.batch_norm(x, torch.ones(2), torch.zeros(2),
                            torch.zeros(2), torch.ones(2), training=True,
                            momentum=0.9)
    flat = x.reshape(-1, 2).double()
    np.testing.assert_allclose(m.numpy(), 0.1 * flat.mean(0).numpy(),
                               rtol=1e-5)
    # the biased batch variance
    np.testing.assert_allclose(
        v.numpy(), 0.9 + 0.1 * flat.var(0, unbiased=False).numpy(),
        rtol=1e-5)


def test_batch_norm_saves_x_and_two_channel_vectors():
    """The backward keeps x itself and per-channel vectors only, no f32
    copy of the activation."""
    x = torch.randn(4, 6, 6, 8, dtype=torch.bfloat16, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        TN.batch_norm(x, torch.ones(8, requires_grad=True), torch.zeros(8),
                      torch.zeros(8), torch.ones(8), training=True)
    big = [t for t in saved if t.numel() == x.numel()]
    assert len(big) == 1 and big[0].dtype == torch.bfloat16
    assert all(t.numel() == 8 for t in saved if t.numel() != x.numel())


def test_batch_norm_bf16_input_matches_jax():
    rs = np.random.RandomState(8)
    x = np_f32(rs, 4, 5, 5, 8)
    scale, offset = 1.0 + 0.1 * np_f32(rs, 8), 0.1 * np_f32(rs, 8)
    zero, one = np.zeros(8, np.float32), np.ones(8, np.float32)

    def jfn(a, s, o):
        return JN.batch_norm(a.astype(jnp.bfloat16), s, o, zero, one,
                             training=True)[0]

    def tfn(a, s, o):
        return TN.batch_norm(a.to(torch.bfloat16), s, o,
                             torch.from_numpy(zero), torch.from_numpy(one),
                             training=True)[0]

    jout, tout, jg, tg = _vjp_pair(jfn, tfn, [x, scale, offset])
    assert tout.dtype == torch.bfloat16 and str(jout.dtype) == "bfloat16"
    _check(jout, tout, jg, tg, BF16_TOL)


@pytest.mark.parametrize("size", [5, 4, 1])
def test_lrn_matches_jax(size):
    x = np_f32(np.random.RandomState(9), 2, 3, 4, 7) * 4.0
    kw = dict(size=size, alpha=1e-2, beta=0.75, k=2.0)
    _check(*_vjp_pair(lambda a: JN.lrn(a, **kw), lambda a: TN.lrn(a, **kw),
                      [x]), F32_TOL)


def test_lrn_does_not_divide_alpha_by_size():
    x = torch.ones(1, 1, 1, 5)
    y = TN.lrn(x, size=3, alpha=0.5, beta=1.0, k=1.0)
    # the middle channel's window holds 3 ones: 1 / (1 + 0.5 * 3)
    assert math.isclose(float(y[0, 0, 0, 2]), 1.0 / 2.5, rel_tol=1e-6)


# -- activations -------------------------------------------------------------------

POSITIVE_ONLY = {"log", "sqrt", "reciprocal"}


def test_activation_table_is_jaxs():
    assert sorted(TA._REGISTRY) == sorted(JA._REGISTRY)
    with pytest.raises(ValueError, match="known:.*'relu'"):
        TNL.get_activation("no_such_activation")
    assert TNL.get_activation(None) is TA.identity
    assert TNL.get_activation(torch.tanh) is torch.tanh


@pytest.mark.parametrize("name", sorted(JA._REGISTRY))
def test_activation_forward_and_vjp_match_jax(name):
    rs = np.random.RandomState(10)
    x = np_f32(rs, 3, 17) * 3.0
    if name in POSITIVE_ONLY:
        x = np.abs(x) + 0.5
    _check(*_vjp_pair(JA.get(name), TA.get(name), [x]), F32_TOL)


@pytest.mark.parametrize("fn,kw", [("stanh", {"scale_a": 0.5, "scale_b": 2}),
                                   ("brelu", {"t_min": -1, "t_max": 2}),
                                   ("leaky_relu", {"alpha": 0.2}),
                                   ("elu", {"alpha": 0.5}),
                                   ("pow_act", {"factor": 3.0}),
                                   ("hard_shrink", {"threshold": 1.0})])
def test_activation_options_match_jax(fn, kw):
    x = np_f32(np.random.RandomState(11), 4, 9) * 2.0
    _check(*_vjp_pair(lambda a: getattr(JA, fn)(a, **kw),
                      lambda a: getattr(TA, fn)(a, **kw), [x]), F32_TOL)


def test_prelu_matches_jax():
    rs = np.random.RandomState(12)
    x, alpha = np_f32(rs, 2, 3, 3, 4), 0.1 * np_f32(rs, 4)
    _check(*_vjp_pair(JA.prelu, TA.prelu, [x, alpha]), F32_TOL)


# -- initializers and layers -------------------------------------------------------


def test_initializer_table_is_jaxs():
    for name in ("zeros", "ones", "xavier", "xavier_normal", "msra",
                 "smart", "normal", "uniform"):
        JI.get(name)
        TI.get(name)
    with pytest.raises(ValueError, match="unknown initializer"):
        TI.get("no_such_init")


@pytest.mark.parametrize("name,shape,kind,scale", [
    ("msra", (3, 3, 32, 64), "normal", math.sqrt(2.0 / (9 * 32))),
    ("xavier_normal", (64, 96), "normal", math.sqrt(2.0 / 160)),
    ("xavier", (3, 3, 16, 32), "uniform",
     math.sqrt(6.0 / (9 * 16 + 9 * 32))),
    ("uniform", (4000,), "uniform", 1.0),
])
def test_initializer_fans_and_distributions_match_jaxs(name, shape, kind,
                                                       scale):
    t = TI.get(name)(np.random.RandomState(0), shape).numpy()
    j = np.asarray(JI.get(name)(jax.random.key(0), shape))
    assert t.shape == j.shape == shape and t.dtype == np.float32
    if kind == "normal":
        for a in (t, j):
            assert abs(a.std() / scale - 1.0) < 0.1
    else:
        for a in (t, j):
            assert np.abs(a).max() <= scale
            assert np.abs(a).max() > 0.95 * scale
    assert np.all(TI.ones(None, (3,)).numpy() == 1.0)


@pytest.mark.parametrize("layer", [
    "Conv2D(8, 7, stride=2)", "Conv2D(8, 3, stride=2, padding='VALID')",
    "Conv2D(6, 3, groups=3, dilation=2)", "Conv2D(4, 5, padding=2)",
    "Conv2D(8, 7, stride=2, space_to_depth=True)",
    "MaxPool2D(3, stride=2, padding='SAME')", "AvgPool2D(3, stride=2, "
    "padding=1)", "GlobalAvgPool2D()", "BatchNorm()", "LRN(5)",
    "Flatten()", "Dropout(0.3)", "LayerNorm()", "Activation('relu')",
])
def test_layer_out_spec_and_trees_match_jax(layer):
    jl = eval("jnn." + layer)
    tl = eval("TNL." + layer)
    spec = (2, 15, 15, 6)
    jout = jl.out_spec(jnn.ShapeSpec(spec))
    assert tl.out_spec(ShapeSpec(spec)).shape == tuple(jout.shape)
    jp, js = jl.init(jax.random.key(0), jnn.ShapeSpec(spec))
    tp, ts = tl.init(0, ShapeSpec(spec), device="cpu")
    for j, t in ((jp, tp), (js, ts)):
        assert jax.tree.map(np.shape, j) == {k: tuple(v.shape)
                                             for k, v in t.items()}


def test_dropout_scales_kept_units_and_needs_a_generator():
    layer = TNL.Dropout(0.25)
    x = torch.ones(64, 256)
    assert layer.apply({}, {}, x)[0] is x
    with pytest.raises(ValueError, match="torch.Generator"):
        layer.apply({}, {}, x, training=True)
    y, _ = layer.apply({}, {}, x, training=True,
                       rng=torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert torch.all(y[kept] == 1.0 / 0.75)
    z, _ = TNL.Dropout(0.0).apply({}, {}, x, training=True)
    assert z is x


def test_dropout_refuses_a_generator_on_another_device():
    """The mask is drawn on the input's device: a generator elsewhere (a
    CPU one for a card tensor) raises instead of drawing on the host."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="generator is on cpu"):
        TNL.Dropout(0.5).apply({}, {}, x, training=True,
                               rng=torch.Generator())


def test_multitask_and_residual_match_jax():
    """nn.composite's MultiTask (one input per sub-network, a tuple out)
    and Residual with a projection shortcut, on JAX's weights."""
    from paddle_tpu_torch.models.weights import params_from_numpy
    from paddle_tpu_torch.nn import composite as TCM
    from paddle_tpu_torch.nn import module as TNM

    def build(nn, cm, seq):
        res = cm.Residual(seq([nn.Dense(5, activation="relu", name="a"),
                               nn.Dense(5, name="b")], name="main"),
                          nn.Dense(5, name="proj"), activation="tanh",
                          name="res")
        return cm.MultiTask([("left", res), ("right", nn.Dense(2))])

    jm = build(jnn, jnn, jnn.Sequential)
    tm = build(TNL, TCM, TNM.Sequential)
    specs = [(3, 4), (3, 6)]
    jp, js = jm.init(jax.random.key(0), *(jnn.ShapeSpec(s) for s in specs))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    rs = np.random.RandomState(13)
    xs = [np_f32(rs, *s) for s in specs]
    jout, _ = jm.apply(jp, js, *map(jnp.asarray, xs))
    tout, _ = tm.apply(tp, {}, *map(torch.from_numpy, xs))
    assert len(tout) == 2
    for j, t in zip(jout, tout):
        assert rel_err(t, np.asarray(j, np.float64)) <= F32_TOL
    with pytest.raises(ValueError, match="2 sub-networks but 1"):
        tm.apply(tp, {}, torch.from_numpy(xs[0]))
