"""The port's CTC (`ops/ctc.py`) and its sampled and tree-structured
output losses (`ops/sampling.py`: NCE, the log-uniform sampler, the
hierarchical sigmoid) against the JAX package's, on the same seeded
numpy inputs, at the JAX tests' shapes (`test_crf_ctc.py`,
`test_detection_sampling.py`).

Tolerances: losses and gradients 1e-5 of their max |value| (the JAX CTC
recursion runs in float64 under the tests' x64 mode, the port's in
f32); decoded ids, tree codes and sampled ids exact. An impossible
alignment costs ~1e30 on both sides (LOG_EPS = -1e30, not -inf), with
finite gradients. The sampler is held on the same uniforms: JAX's draw
is handed to the port as `u`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import ctc as JK
from paddle_tpu.ops import sampling as JS
from paddle_tpu_torch.ops import ctc as TK
from paddle_tpu_torch.ops import sampling as TS
from torch_parity import np_f32, op_parity, rel_err


def _log_softmax(rs, *shape):
    return np.asarray(jax.nn.log_softmax(jnp.asarray(np_f32(rs, *shape)),
                                         axis=-1))


CTC = {
    # name: (T, C, labels, input_lengths, label_lengths, blank); labels
    # never hold the blank id
    "full": (6, 4, [[1, 2, 3], [2, 2, 1]], [6, 6], [3, 2], 0),
    "ragged": (6, 3, [[0, 0], [1, 0]], [3, 6], [1, 2], 2),
    "repeated": (5, 3, [[1, 1], [1, 1]], [5, 4], [2, 2], 0),
    "empty_label": (4, 3, [[0, 0], [1, 0]], [4, 4], [0, 1], 2),
    # three labels (two repeated) need four frames: impossible in three
    "impossible": (3, 3, [[1, 1, 2], [2, 1, 1]], [3, 3], [3, 1], 0),
}


@pytest.mark.parametrize("name", sorted(CTC))
def test_ctc_loss_matches_jax(name):
    t, c, labels, in_lens, lab_lens, blank = CTC[name]
    rs = np.random.RandomState(sorted(CTC).index(name))
    args = [_log_softmax(rs, 2, t, c), np.asarray(in_lens, np.int32),
            np.asarray(labels, np.int32), np.asarray(lab_lens, np.int32)]
    got = op_parity(lambda *a: JK.ctc_loss(*a, blank=blank),
                    lambda *a: TK.ctc_loss(*a, blank=blank), args,
                    diff=(0,))
    loss = got[0]
    assert torch.isfinite(loss).all()
    if name == "impossible":
        assert float(loss[0]) > 1e29 and float(loss[1]) < 1e3


def test_ctc_greedy_decode_matches_jax():
    rs = np.random.RandomState(0)
    lp = np.array(_log_softmax(rs, 3, 9, 4))
    lp[0, 2:5] = [0.0, -9, -9, -9]        # a repeated frame and blanks
    lens = np.asarray([9, 5, 0], np.int32)
    for blank in (0, 2):
        op_parity(lambda a, b: JK.ctc_greedy_decode(a, b, blank=blank),
                  lambda a, b: TK.ctc_greedy_decode(a, b, blank=blank),
                  [lp, lens], exact=True)


def _nce_args(rs, v=12, d=4, b=3, s=5):
    return [np_f32(rs, v, d) * 0.3, np_f32(rs, v) * 0.1,
            np_f32(rs, b, d) * 0.3, np.asarray([1, 5, 9], np.int32)[:b],
            rs.randint(0, v, (b, s)).astype(np.int32)]


def test_nce_loss_matches_jax():
    rs = np.random.RandomState(1)
    args = _nce_args(rs)
    op_parity(JS.nce_loss, TS.nce_loss, args, diff=(0, 1, 2))
    # the log(k Q) correction from a per-class distribution...
    q = np.asarray(JS.log_uniform_prob(jnp.arange(12, dtype=jnp.int32), 12))
    op_parity(lambda *a: JS.nce_loss(*a[:5], noise_probs=a[5]),
              lambda *a: TS.nce_loss(*a[:5], noise_probs=a[5]),
              args + [q], diff=(0, 1, 2))
    # ... and per sample, with the true class's probabilities beside it
    nq, tq = q[args[4]], q[args[3]]
    op_parity(lambda *a: JS.nce_loss(*a[:5], noise_probs=a[5],
                                     true_probs=a[6]),
              lambda *a: TS.nce_loss(*a[:5], noise_probs=a[5],
                                     true_probs=a[6]),
              args + [nq, tq], diff=(0, 1, 2))
    with pytest.raises(ValueError, match="true_probs"):
        TS.nce_loss(*map(torch.from_numpy, args),
                    noise_probs=torch.from_numpy(nq))


def test_log_uniform_sample_maps_the_same_uniforms():
    key = jax.random.key(7)
    want = np.asarray(JS.log_uniform_sample(key, 16, 1000, shape=(64,)))
    # JAX's draw, float64 under the tests' x64 mode
    u = np.asarray(jax.random.uniform(key, (64, 16)))
    got = TS.log_uniform_sample(None, 16, 1000, (64,),
                                u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    # the same rule on f32 uniforms, and the ends of the range
    u32 = np.asarray([0.0, 1e-7, 0.5, 0.999999, 1.0 - 2 ** -24],
                     np.float32)
    got = TS.log_uniform_sample(None, 5, 1000, u=torch.from_numpy(u32))
    want = np.clip((np.exp(u32 * np.float32(np.log(1001.0))) - 1.0
                    ).astype(np.int32), 0, 999)
    np.testing.assert_array_equal(got.numpy(), want)
    # drawn from a generator: in range, and repeatable from its seed
    draw = lambda: TS.log_uniform_sample(torch.Generator().manual_seed(3),
                                         8, 50, (4,))
    a = draw()
    assert a.shape == (4, 8) and int(a.min()) >= 0 and int(a.max()) < 50
    assert torch.equal(a, draw())


def test_log_uniform_prob_matches_jax():
    ids = np.arange(40, dtype=np.int32)
    op_parity(lambda i: JS.log_uniform_prob(i, 40),
              lambda i: TS.log_uniform_prob(i, 40), [ids], tol=1e-6)
    assert abs(float(TS.log_uniform_prob(torch.arange(40), 40).sum())
               - 1.0) < 1e-5


@pytest.mark.parametrize("num_classes", [1, 2, 4, 6, 9])
def test_build_binary_tree_codes_is_the_jax_copy(num_classes):
    for got, want in zip(TS.build_binary_tree_codes(num_classes),
                         JS.build_binary_tree_codes(num_classes)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _hsig_args(rs, num_classes, b=3, d=4):
    ids, signs = JS.build_binary_tree_codes(num_classes)
    return [np_f32(rs, num_classes - 1, d) * 0.3,
            np_f32(rs, num_classes - 1) * 0.1, np_f32(rs, b, d) * 0.3,
            rs.randint(0, num_classes, b).astype(np.int32), ids, signs]


@pytest.mark.parametrize("num_classes", [6, 8])
def test_hsigmoid_loss_matches_jax(num_classes):
    args = _hsig_args(np.random.RandomState(num_classes), num_classes)
    op_parity(JS.hsigmoid_loss, TS.hsigmoid_loss, args, diff=(0, 1, 2))


def test_hsigmoid_predict_matches_jax():
    args = _hsig_args(np.random.RandomState(3), 7)
    del args[3]
    got = op_parity(JS.hsigmoid_predict, TS.hsigmoid_predict, args,
                    diff=(0, 1, 2))[0]
    # a proper distribution over the classes
    assert rel_err(torch.exp(got).sum(-1), np.ones(3)) < 1e-5
