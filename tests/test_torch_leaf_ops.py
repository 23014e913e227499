"""The port's leaf ops against the JAX package's, on the same seeded numpy
inputs: the losses (values and gradients), the row-wise linalg ops, the
in-graph metrics, `ops/misc.py` and the two norms added to
`ops/norm.py`. One case per function, at the JAX tests' shapes
(`test_ops.py`, `test_op_gaps.py`, `test_detection_sampling.py`).

Tolerances (f32): outputs and gradients 1e-5 of the output's max
|value| (`torch_parity.op_parity`); ids, masks and top-k results exact.
Tied inputs are planted where JAX's order decides a result (top-k,
maxid, lambda_rank's ranks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import linalg as JL
from paddle_tpu.ops import losses as JLS
from paddle_tpu.ops import metrics as JM
from paddle_tpu.ops import misc as JMI
from paddle_tpu.ops import norm as JN
from paddle_tpu_torch.ops import linalg as TL
from paddle_tpu_torch.ops import losses as TLS
from paddle_tpu_torch.ops import metrics as TM
from paddle_tpu_torch.ops import misc as TMI
from paddle_tpu_torch.ops import norm as TN
from torch_parity import np_f32, op_parity

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _probs(rs, *shape):
    z = np.exp(np_f32(rs, *shape))
    return (z / z.sum(-1, keepdims=True)).astype(np.float32)


def _bits(rs, *shape):
    return (rs.rand(*shape) > 0.5).astype(np.float32)


# -- losses ---------------------------------------------------------------------


@case
def reduce_loss(rs):
    per, w = np_f32(rs, 6), rs.rand(6).astype(np.float32)
    for red in ("mean", "sum", "none"):
        op_parity(lambda a, b: JLS.reduce_loss(a, b, red),
                  lambda a, b: TLS.reduce_loss(a, b, red), [per, w],
                  diff=(0, 1))
        op_parity(lambda a: JLS.reduce_loss(a, None, red),
                  lambda a: TLS.reduce_loss(a, None, red), [per], diff=(0,))
    # weights summing below 1 divide by 1
    op_parity(JLS.reduce_loss, TLS.reduce_loss, [per, w * 0.01], diff=(0,))


@case
def soft_label_cross_entropy(rs):
    op_parity(JLS.soft_label_cross_entropy, TLS.soft_label_cross_entropy,
              [np_f32(rs, 4, 6), _probs(rs, 4, 6)], diff=(0, 1))


@case
def cross_entropy_with_probs(rs):
    labels = rs.randint(0, 6, 4).astype(np.int32)
    op_parity(JLS.cross_entropy_with_probs, TLS.cross_entropy_with_probs,
              [_probs(rs, 4, 6), labels], diff=(0,))


@case
def multi_binary_label_cross_entropy(rs):
    op_parity(JLS.multi_binary_label_cross_entropy,
              TLS.multi_binary_label_cross_entropy,
              [3 * np_f32(rs, 4, 6), _bits(rs, 4, 6)], diff=(0,))


@case
def squared_error(rs):
    assert TLS.mse is TLS.squared_error
    op_parity(JLS.squared_error, TLS.squared_error,
              [np_f32(rs, 4, 3, 2), np_f32(rs, 4, 3, 2)], diff=(0, 1))
    # rank 1 (the recommender's [B] ratings): one value per element
    op_parity(JLS.squared_error, TLS.squared_error,
              [np_f32(rs, 6), np_f32(rs, 6)], diff=(0, 1))


@case
def huber_regression(rs):
    p, t = 2 * np_f32(rs, 5, 4), np_f32(rs, 5, 4)
    for delta in (1.0, 0.5):
        op_parity(lambda a, b: JLS.huber_regression(a, b, delta),
                  lambda a, b: TLS.huber_regression(a, b, delta), [p, t],
                  diff=(0, 1))
    op_parity(JLS.huber_regression, TLS.huber_regression, [p[0], t[0]],
              diff=(0, 1))


@case
def huber_classification(rs):
    assert TLS.modified_huber_loss is TLS.huber_classification
    # a = y * z spans all three regions: < -1, [-1, 1], > 1
    z = np.asarray([-3.0, -0.5, 0.2, 2.5, -1.5, 0.9], np.float32)
    y = np.asarray([1, 1, 0, 1, 0, 0], np.float32)
    op_parity(JLS.huber_classification, TLS.huber_classification, [z, y],
              diff=(0,))
    op_parity(JLS.huber_classification, TLS.huber_classification,
              [z[:, None], y], diff=(0,))


@case
def smooth_l1(rs):
    p, t = np_f32(rs, 5, 4), np_f32(rs, 5, 4)
    for sigma in (1.0, 2.0):
        op_parity(lambda a, b: JLS.smooth_l1(a, b, sigma),
                  lambda a, b: TLS.smooth_l1(a, b, sigma), [p, t],
                  diff=(0, 1))
    op_parity(JLS.smooth_l1, TLS.smooth_l1, [p[0], t[0]], diff=(0, 1))


@case
def hinge_loss(rs):
    op_parity(JLS.hinge_loss, TLS.hinge_loss,
              [2 * np_f32(rs, 4, 3), _bits(rs, 4, 3)], diff=(0,))


@case
def rank_cost(rs):
    # large gaps too: softplus must stay logaddexp(x, 0) past x = 20
    left = np.asarray([0.3, -1.0, 25.0, -30.0, 2.0], np.float32)
    right = np.asarray([0.1, 0.5, -1.0, 0.0, 2.0], np.float32)
    label = rs.rand(5).astype(np.float32)
    op_parity(JLS.rank_cost, TLS.rank_cost, [left, right, label],
              diff=(0, 1, 2))


@case
def margin_rank_loss(rs):
    label = np.where(rs.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
    op_parity(lambda a, b, c: JLS.margin_rank_loss(a, b, c, 0.1),
              lambda a, b, c: TLS.margin_rank_loss(a, b, c, 0.1),
              [np_f32(rs, 6), np_f32(rs, 6), label], diff=(0, 1))


@case
def lambda_rank_segment(rs):
    # tied scores: the ranks follow the stable sort's index order
    scores = np.asarray([0.5, 1.2, 0.5, -0.3, 1.2, 0.0, 0.5, 2.0],
                        np.float32)
    rel = np.asarray([2, 0, 1, 3, 1, 0, 2, 1], np.float32)
    for k in (3, 5):
        op_parity(lambda s, r: JLS.lambda_rank_segment(s, r, ndcg_num=k),
                  lambda s, r: TLS.lambda_rank_segment(s, r, ndcg_num=k),
                  [scores, rel], diff=(0,))
    op_parity(JLS.lambda_rank_segment, TLS.lambda_rank_segment,
              [np_f32(rs, 8), rel * 0], diff=(0,))


@case
def cos_sim(rs):
    a, b = np_f32(rs, 4, 8), np_f32(rs, 4, 8)
    op_parity(lambda x, y: JLS.cos_sim(x, y, scale=5.0),
              lambda x, y: TLS.cos_sim(x, y, scale=5.0), [a, b],
              diff=(0, 1))
    b[1] = 0.0       # a zero row: the epsilon floor (sqrt's gradient at 0
    op_parity(JLS.cos_sim, TLS.cos_sim, [a, b])     # is nan on both sides)


@case
def squared_l2_distance(rs):
    op_parity(JLS.squared_l2_distance, TLS.squared_l2_distance,
              [np_f32(rs, 4, 5), np_f32(rs, 4, 5)], diff=(0, 1))


@case
def l1_norm(rs):
    op_parity(JLS.l1_norm, TLS.l1_norm, [np_f32(rs, 4, 5)], diff=(0,))


@case
def squared_l2_norm(rs):
    op_parity(JLS.squared_l2_norm, TLS.squared_l2_norm, [np_f32(rs, 4, 5)],
              diff=(0,))


# -- linalg ---------------------------------------------------------------------


@case
def multiplex(rs):
    idx = np.asarray([2, 0, 1, 2], np.int32)
    ins = [np_f32(rs, 4, 3) for _ in range(3)]
    op_parity(lambda i, a, b, c: JL.multiplex(i, a, b, c),
              lambda i, a, b, c: TL.multiplex(i, a, b, c), [idx] + ins,
              diff=(1, 2, 3))


@case
def bilinear_tensor_product(rs):
    args = [np_f32(rs, 3, 4), np_f32(rs, 3, 5), np_f32(rs, 2, 4, 5),
            np_f32(rs, 2)]
    op_parity(JL.bilinear_tensor_product, TL.bilinear_tensor_product, args,
              diff=(0, 1, 2, 3))
    op_parity(JL.bilinear_tensor_product, TL.bilinear_tensor_product,
              args[:3], diff=(0, 1, 2))


@case
def conv_shift(rs):
    op_parity(JL.conv_shift, TL.conv_shift, [np_f32(rs, 3, 7),
                                             np_f32(rs, 3, 3)], diff=(0, 1))
    op_parity(JL.conv_shift, TL.conv_shift, [np_f32(rs, 2, 5),
                                             np_f32(rs, 2, 5)], diff=(0, 1))
    with pytest.raises(ValueError, match="odd"):
        TL.conv_shift(torch.zeros(2, 6), torch.zeros(2, 2))
    with pytest.raises(ValueError, match="exceeds"):
        TL.conv_shift(torch.zeros(2, 3), torch.zeros(2, 5))


@case
def dot_prod(rs):
    op_parity(JL.dot_prod, TL.dot_prod, [np_f32(rs, 4, 5), np_f32(rs, 4, 5)],
              diff=(0, 1))


@case
def out_prod(rs):
    op_parity(JL.out_prod, TL.out_prod, [np_f32(rs, 4, 5), np_f32(rs, 4, 3)],
              diff=(0, 1))


@case
def convex_comb(rs):
    op_parity(JL.convex_comb, TL.convex_comb,
              [rs.rand(2, 3).astype(np.float32), np_f32(rs, 2, 12)],
              diff=(0, 1))


@case
def selective_fc(rs):
    sel = np.asarray([[0, 5, 19], [1, 1, 2], [7, 3, 11]], np.int32)
    args = [np_f32(rs, 3, 6), np_f32(rs, 6, 20), np_f32(rs, 20), sel]
    op_parity(JL.selective_fc, TL.selective_fc, args, diff=(0, 1, 2))
    op_parity(lambda x, k, s: JL.selective_fc(x, k, None, s),
              lambda x, k, s: TL.selective_fc(x, k, None, s),
              [args[0], args[1], sel], diff=(0, 1))


# -- in-graph metrics -----------------------------------------------------------


def _tied_logits(rs):
    # small integers: many ties, so the first maximum decides
    return rs.randint(0, 3, (16, 6)).astype(np.float32)


@case
def accuracy(rs):
    op_parity(JM.accuracy, TM.accuracy,
              [_tied_logits(rs), rs.randint(0, 6, 16).astype(np.int32)],
              exact=True)


@case
def classification_error(rs):
    op_parity(JM.classification_error, TM.classification_error,
              [_tied_logits(rs), rs.randint(0, 6, 16).astype(np.int32)],
              exact=True)


@case
def top_k_accuracy(rs):
    logits, labels = _tied_logits(rs), rs.randint(0, 6, 16).astype(np.int32)
    for k in (1, 2, 3):
        op_parity(lambda a, b: JM.top_k_accuracy(a, b, k),
                  lambda a, b: TM.top_k_accuracy(a, b, k), [logits, labels],
                  exact=True)


# -- misc -----------------------------------------------------------------------


@case
def power(rs):
    x = (rs.rand(3, 4) + 0.5).astype(np.float32)
    op_parity(JMI.power, TMI.power, [x, np.asarray([1.0, 2.0, 0.5],
                                                   np.float32)],
              diff=(0, 1))
    op_parity(JMI.power, TMI.power,
              [x, np.asarray([[1.5], [3.0], [0.25]], np.float32)],
              diff=(0, 1))


@case
def slope_intercept(rs):
    op_parity(lambda x: JMI.slope_intercept(x, 2.0, 1.0),
              lambda x: TMI.slope_intercept(x, 2.0, 1.0),
              [np_f32(rs, 3, 4)], diff=(0,))


@case
def sum_to_one_norm(rs):
    x = (rs.rand(4, 5) + 0.1).astype(np.float32)
    x[2] = [1.0, -1.0, 0.5, -0.5, 0.0]     # sums to 0: divided by 1
    op_parity(JMI.sum_to_one_norm, TMI.sum_to_one_norm, [x], diff=(0,))


@case
def switch_order(rs):
    x = np_f32(rs, 2, 4, 5, 3)
    op_parity(JMI.switch_order, TMI.switch_order, [x], exact=True)
    op_parity(lambda a: JMI.switch_order(a, (0, 2, 3, 1), (2, 60)),
              lambda a: TMI.switch_order(a, (0, 2, 3, 1), (2, 60)), [x],
              exact=True)


@case
def trans(rs):
    op_parity(JMI.trans, TMI.trans, [np_f32(rs, 3, 7)], exact=True)
    op_parity(JMI.trans, TMI.trans, [np_f32(rs, 2, 3, 7)], exact=True)
    with pytest.raises(ValueError):
        TMI.trans(torch.zeros(3))


@case
def resize(rs):
    op_parity(lambda a: JMI.resize(a, 21), lambda a: TMI.resize(a, 21),
              [np_f32(rs, 3, 7)], exact=True)


@case
def maxid(rs):
    m = _tied_logits(rs)
    op_parity(JMI.maxid, TMI.maxid, [m], exact=True)
    op_parity(lambda a: JMI.maxid(a, beam=3), lambda a: TMI.maxid(a, beam=3),
              [m], exact=True)


@case
def sampling_id(rs):
    probs = _probs(rs, 6, 9)
    probs[0] = [0, 0, 1, 0, 0, 0, 0, 0, 0]
    key = jax.random.key(3)
    # JAX's categorical is argmax(gumbel(key) + logits): hand the port the
    # same Gumbel draws
    noise = np.asarray(jax.random.gumbel(key, probs.shape, jnp.float32))
    want = np.asarray(JMI.sampling_id(key, jnp.asarray(probs)))
    got = TMI.sampling_id(None, torch.from_numpy(probs),
                          noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0]) == 2
    # drawn from a generator: the same draw twice from the same seed
    g = lambda: torch.Generator().manual_seed(5)
    a = TMI.sampling_id(g(), torch.from_numpy(probs))
    assert torch.equal(a, TMI.sampling_id(g(), torch.from_numpy(probs)))


@case
def scale_shift(rs):
    op_parity(JMI.scale_shift, TMI.scale_shift,
              [np_f32(rs, 3, 4), np.float32(1.5), np.float32(-0.5)],
              diff=(0, 1, 2))
    op_parity(JMI.scale_shift, TMI.scale_shift,
              [np_f32(rs, 3, 4), np.float32(1.5)], diff=(0, 1))


@case
def scale_sub_region(rs):
    boxes = np.asarray([[1, 1, 2, 3, 2, 4], [2, 3, 1, 4, 1, 1]], np.int32)
    op_parity(lambda x, b: JMI.scale_sub_region(x, b, 10.0),
              lambda x, b: TMI.scale_sub_region(x, b, 10.0),
              [np_f32(rs, 2, 4, 4, 3), boxes], diff=(0,))


@case
def data_norm(rs):
    x = np_f32(rs, 16, 3) * 4 + 2
    stats = {"mean": x.mean(0), "std": x.std(0), "min": x.min(0),
             "max": x.max(0),
             "decimal_scale": np.asarray([10.0, 100.0, 10.0], np.float32)}
    keys = sorted(stats)
    for mode in ("z-score", "min-max", "decimal-scaling"):
        op_parity(
            lambda a, *s: JMI.data_norm(a, dict(zip(keys, s)), mode=mode),
            lambda a, *s: TMI.data_norm(a, dict(zip(keys, s)), mode=mode),
            [x] + [stats[k] for k in keys], diff=(0,))
    with pytest.raises(ValueError, match="unknown data_norm mode"):
        TMI.data_norm(torch.zeros(2, 3), {}, mode="bogus")


@case
def row_conv(rs):
    x, w = np_f32(rs, 2, 6, 3), np_f32(rs, 3, 3)
    op_parity(JMI.row_conv, TMI.row_conv, [x, w], diff=(0, 1))
    op_parity(JMI.row_conv, TMI.row_conv,
              [x, w, np.asarray([6, 4], np.int32)], diff=(0, 1))


# -- norms ----------------------------------------------------------------------


@case
def cross_channel_norm(rs):
    op_parity(JN.cross_channel_norm, TN.cross_channel_norm,
              [np_f32(rs, 2, 3, 3, 4), np_f32(rs, 4)], diff=(0, 1))


@case
def l2_normalize(rs):
    x = np_f32(rs, 3, 5, 4)
    op_parity(JN.l2_normalize, TN.l2_normalize, [x], diff=(0,))
    op_parity(lambda a: JN.l2_normalize(a, axis=1),
              lambda a: TN.l2_normalize(a, axis=1), [x], diff=(0,))


@pytest.mark.parametrize("name", sorted(CASES))
def test_leaf_op_matches_jax(name):
    CASES[name](np.random.RandomState(sorted(CASES).index(name)))
