"""The rest of the port's `ops/conv.py`, its `ops/detection.py` and
`metrics/detection.py` against the JAX package's, on the same seeded
numpy inputs, at the JAX tests' shapes (`test_ops.py`, `test_op_gaps.py`,
`test_detection_sampling.py`, `test_metrics.py`).

Tolerances (f32): outputs and gradients 1e-5 of the output's max |value|
(`torch_parity.op_parity`); indices, matches, NMS keep-masks, classes
and the mAP evaluator's results exact. Where the JAX semantics differ
from torch's library calls, the cases pin them: `conv2d_transpose` at
strides 1 and 2, odd and even kernels, SAME, VALID and explicit pads;
the resizes up and down (jax.image antialiases when it downsamples, and
its nearest uses half-pixel centres); XLA's uneven SAME padding in 3-D;
pooling ties, padded cells and integer maps; zero-score ties in the
detection output."""

import numpy as np
import pytest
import torch

from paddle_tpu.metrics import detection as JMD
from paddle_tpu.ops import conv as JC
from paddle_tpu.ops import detection as JD
from paddle_tpu_torch.metrics import DetectionMAPEvaluator
from paddle_tpu_torch.metrics import detection as TMD
from paddle_tpu_torch.ops import conv as TC
from paddle_tpu_torch.ops import detection as TD
from torch_parity import np_f32, op_parity

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# -- conv -----------------------------------------------------------------------

TRANSPOSE = [(1, 3, "SAME"), (2, 3, "SAME"), (1, 2, "SAME"), (2, 2, "SAME"),
             (2, 4, "SAME"), (1, 3, "VALID"), (2, 3, "VALID"),
             (2, 4, "VALID"), (2, 3, ((1, 0), (2, 1))), (1, 2, 1),
             (2, 3, ((4, 3), (0, -1)))]


@pytest.mark.parametrize("stride,k,padding", TRANSPOSE)
def test_conv2d_transpose_matches_lax(stride, k, padding):
    rs = np.random.RandomState(k * 10 + stride)
    args = [np_f32(rs, 2, 5, 6, 3), np_f32(rs, k, k, 3, 4), np_f32(rs, 4)]
    op_parity(
        lambda x, w, b: JC.conv2d_transpose(x, w, stride=stride,
                                            padding=padding, bias=b),
        lambda x, w, b: TC.conv2d_transpose(x, w, stride=stride,
                                            padding=padding, bias=b),
        args, diff=(0, 1, 2))


@case
def depthwise_conv2d(rs):
    for stride, padding in ((1, "SAME"), (2, "SAME"), (1, "VALID")):
        op_parity(
            lambda x, w: JC.depthwise_conv2d(x, w, stride=stride,
                                             padding=padding),
            lambda x, w: TC.depthwise_conv2d(x, w, stride=stride,
                                             padding=padding),
            [np_f32(rs, 2, 7, 6, 3), np_f32(rs, 3, 3, 1, 6)], diff=(0, 1))


@case
def spp(rs):
    # JAX's spp reads its bin edges as host ints: it runs eagerly here
    x = np_f32(rs, 2, 7, 9, 3)
    op_parity(lambda a: JC.spp(a, 3, "max"), lambda a: TC.spp(a, 3, "max"),
              [x], jit=False)
    op_parity(lambda a: JC.spp(a, 2, "avg"), lambda a: TC.spp(a, 2, "avg"),
              [x], diff=(0,), jit=False)


@case
def pad(rs):
    x = np_f32(rs, 2, 3, 4, 2)
    for p in (((0, 0), (1, 2), (0, 1), (0, 0)), 1, (2, 0)):
        op_parity(lambda a: JC.pad(a, p, 0.5), lambda a: TC.pad(a, p, 0.5),
                  [x], diff=(0,))


@case
def crop(rs):
    x = np_f32(rs, 2, 6, 5, 3)
    # the second offset set runs past the end: clamped back, as
    # lax.dynamic_slice does
    for off in ((0, 1, 2, 0), (1, 4, 3, 1)):
        op_parity(lambda a: JC.crop(a, off, (1, 3, 2, 2)),
                  lambda a: TC.crop(a, off, (1, 3, 2, 2)), [x], diff=(0,))


@case
def im2col(rs):
    x = np_f32(rs, 2, 7, 6, 3)
    for win, stride, padding in ((3, 1, "VALID"), (3, 2, "SAME"),
                                 ((2, 3), (2, 1), 1)):
        op_parity(lambda a: JC.im2col(a, win, stride=stride,
                                      padding=padding),
                  lambda a: TC.im2col(a, win, stride=stride,
                                      padding=padding), [x], diff=(0,))


@case
def roi_pool(rs):
    x = np_f32(rs, 2, 8, 8, 3)
    rois = np.asarray([[0, 0, 0, 7, 7], [1, 1.5, 2.2, 5.1, 6.8],
                       [1, 3, 3, 3, 3],
                       [0, 6, 6, 14, 12]],      # past the map: empty bins
                      np.float32)
    for out, scale in (((2, 2), 1.0), ((3, 2), 0.5)):
        op_parity(lambda a, r: JC.roi_pool(a, r, out, scale),
                  lambda a, r: TC.roi_pool(a, r, out, scale), [x, rois],
                  diff=(0,))


@case
def conv3d(rs):
    x = np_f32(rs, 2, 5, 6, 7, 3)
    for stride, padding in ((1, "VALID"), (2, "SAME"), (1, 1),
                            ((1, 2, 2), "SAME")):
        op_parity(lambda a, w, b: JC.conv3d(a, w, stride=stride,
                                            padding=padding, bias=b),
                  lambda a, w, b: TC.conv3d(a, w, stride=stride,
                                            padding=padding, bias=b),
                  [x, np_f32(rs, 3, 2, 3, 3, 4), np_f32(rs, 4)],
                  diff=(0, 1, 2))


POOL3D = ((2, None, "VALID"), (3, 2, "SAME"), (2, 1, 1), ((2, 3, 2), 1,
                                                          "SAME"))


@case
def max_pool3d(rs):
    x = np_f32(rs, 2, 5, 6, 7, 3)
    for w, s, p in POOL3D:
        op_parity(lambda a: JC.max_pool3d(a, w, stride=s, padding=p),
                  lambda a: TC.max_pool3d(a, w, stride=s, padding=p), [x],
                  diff=(0,))


@case
def avg_pool3d(rs):
    x = np_f32(rs, 2, 5, 6, 7, 3)
    for w, s, p in POOL3D:
        op_parity(lambda a: JC.avg_pool3d(a, w, stride=s, padding=p),
                  lambda a: TC.avg_pool3d(a, w, stride=s, padding=p), [x],
                  diff=(0,))


@case
def maxout(rs):
    x = np_f32(rs, 3, 4, 6)
    x[0, 0, :2] = 1.5            # a tie: both share the gradient
    op_parity(lambda a: JC.maxout(a, 2), lambda a: TC.maxout(a, 2), [x],
              diff=(0,))
    with pytest.raises(ValueError, match="not divisible"):
        TC.maxout(torch.zeros(2, 5), 3)


@case
def block_expand(rs):
    x = np_f32(rs, 2, 6, 7, 3)
    for block, stride in ((2, None), ((3, 2), 1)):
        op_parity(lambda a: JC.block_expand(a, block, stride=stride),
                  lambda a: TC.block_expand(a, block, stride=stride), [x],
                  diff=(0,))


@case
def bilinear_interp(rs):
    for hw, out in (((4, 5), (8, 7)), ((8, 8), (3, 5)), ((6, 4), (6, 9)),
                    ((5, 7), (2, 2))):
        x = np_f32(rs, 2, *hw, 3)
        for ac in (False, True):
            op_parity(lambda a: JC.bilinear_interp(a, out, align_corners=ac),
                      lambda a: TC.bilinear_interp(a, out, align_corners=ac),
                      [x], diff=(0,) if ac == (hw[0] > out[0]) else ())


@case
def nearest_interp(rs):
    for hw, out in (((4, 5), (8, 7)), ((8, 8), (3, 5)), ((7, 3), (4, 3))):
        op_parity(lambda a: JC.nearest_interp(a, out),
                  lambda a: TC.nearest_interp(a, out),
                  [np_f32(rs, 2, *hw, 3)], exact=True)


@case
def rotate90(rs):
    x = np_f32(rs, 2, 3, 5, 2)
    for rev in (False, True):
        op_parity(lambda a: JC.rotate90(a, reverse=rev),
                  lambda a: TC.rotate90(a, reverse=rev), [x], exact=True)


WITH_INDEX = ((2, None, "VALID"), (3, 2, "SAME"), (2, 1, "VALID"),
              (3, 2, 1))


@case
def max_pool2d_with_index(rs):
    floats = np_f32(rs, 2, 6, 8, 3)
    ties = rs.randint(0, 3, (2, 5, 7, 2)).astype(np.float32)
    negative = np.full((1, 5, 5, 1), -1.0, np.float32)
    ints = rs.randint(-9, 9, (2, 5, 6, 2)).astype(np.int32)
    runs = [(g, floats) for g in WITH_INDEX] + [
        (WITH_INDEX[1], ties), (WITH_INDEX[3], ties),
        (WITH_INDEX[1], negative), (WITH_INDEX[0], ints),
        (WITH_INDEX[3], ints)]
    for (w, s, p), x in runs:
        op_parity(
            lambda a: JC.max_pool2d_with_index(a, w, stride=s, padding=p),
            lambda a: TC.max_pool2d_with_index(a, w, stride=s, padding=p),
            [x], exact=True)
    op_parity(lambda a: JC.max_pool2d_with_index(a, 2)[0],
              lambda a: TC.max_pool2d_with_index(a, 2)[0], [floats],
              diff=(0,))


@case
def max_unpool2d(rs):
    for x, w, s in ((np_f32(rs, 2, 4, 6, 3), 2, None),
                    (np_f32(rs, 1, 5, 5, 2), 2, 1)):    # overlapping
        hw = x.shape[1:3]
        op_parity(
            lambda a: JC.max_unpool2d(*JC.max_pool2d_with_index(
                a, w, stride=s), hw),
            lambda a: TC.max_unpool2d(*TC.max_pool2d_with_index(
                a, w, stride=s), hw), [x], exact=True)
    # a cell several windows selected holds its value once
    x = np.zeros((1, 3, 3, 1), np.float32)
    x[0, 1, 1, 0] = 5.0
    up = TC.max_unpool2d(*TC.max_pool2d_with_index(
        torch.from_numpy(x), 2, stride=1), (3, 3))
    assert float(up[0, 1, 1, 0]) == 5.0


# -- detection ------------------------------------------------------------------


def _priors(fm=4, img=64, sizes=(24.0,), **kw):
    return JD.prior_boxes((fm, fm), (img, img), min_sizes=list(sizes), **kw)


def _gt(rs, m):
    lo = rs.uniform(0.05, 0.55, (m, 2))
    return np.concatenate([lo, lo + rs.uniform(0.1, 0.4, (m, 2))],
                          1).astype(np.float32)


@case
def prior_boxes(rs):
    for kw in (dict(), dict(max_sizes=[32.0], aspect_ratios=[2.0, 3.0]),
               dict(flip=False, clip=False, aspect_ratios=[2.0])):
        want = JD.prior_boxes((3, 2), (64, 48), [16.0], **kw)
        got = TD.prior_boxes((3, 2), (64, 48), [16.0], **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@case
def encode_boxes(rs):
    priors = _priors()
    op_parity(lambda g: JD.encode_boxes(g, priors),
              lambda g: TD.encode_boxes(g, priors),
              [_gt(rs, priors.shape[0])], diff=(0,))


@case
def decode_boxes(rs):
    priors = _priors()
    op_parity(lambda d: JD.decode_boxes(d, priors, (0.1, 0.1, 0.3, 0.3)),
              lambda d: TD.decode_boxes(d, priors, (0.1, 0.1, 0.3, 0.3)),
              [0.5 * np_f32(rs, priors.shape[0], 4)], diff=(0,))


@case
def iou(rs):
    a, b = _gt(rs, 5), _gt(rs, 4)
    b[0] = a[1]
    op_parity(JD.iou, TD.iou, [a, b], diff=(0, 1))


@case
def match_priors(rs):
    # two GTs sharing a best prior resolve to the higher index; a padded
    # GT never clobbers a real match
    priors = np.asarray([[0.0, 0.0, 0.2, 0.2], [0.6, 0.6, 0.8, 0.8],
                         [0.5, 0.5, 0.7, 0.7]], np.float32)
    gt = np.asarray([[0.0, 0.0, 0.21, 0.21], [0.0, 0.0, 0.19, 0.19],
                     [0.0, 0.0, 0.0, 0.0]], np.float32)
    valid = np.asarray([True, True, False])
    got = op_parity(JD.match_priors, TD.match_priors, [priors, gt, valid],
                    exact=True)
    assert got[0].tolist() == [1, -1, -1]
    pr = _priors()
    for thr in (0.5, 0.2):
        op_parity(lambda p, g, v: JD.match_priors(p, g, v, thr),
                  lambda p, g, v: TD.match_priors(p, g, v, thr),
                  [pr, _gt(rs, 4), np.asarray([True, True, False, True])],
                  exact=True)


@case
def multibox_loss(rs):
    priors = _priors()
    n = priors.shape[0]
    gt, labels = _gt(rs, 3), np.asarray([1, 2, 1], np.int32)
    for valid, ratio in ((np.asarray([True, True, False]), 3.0),
                         (np.asarray([True, False, False]), 1.0)):
        op_parity(
            lambda l, c, g, y, v: JD.multibox_loss(l, c, priors, g, y, v,
                                                   neg_pos_ratio=ratio),
            lambda l, c, g, y, v: TD.multibox_loss(l, c, priors, g, y, v,
                                                   neg_pos_ratio=ratio),
            [0.1 * np_f32(rs, n, 4), np_f32(rs, n, 3), gt, labels, valid],
            diff=(0, 1))
    # tied background losses: the stable sort picks the lower indices
    op_parity(lambda l, c, g, y, v: JD.multibox_loss(l, c, priors, g, y, v),
              lambda l, c, g, y, v: TD.multibox_loss(l, c, priors, g, y, v),
              [np.zeros((n, 4), np.float32), np.zeros((n, 3), np.float32),
               gt, labels, valid], diff=(0, 1))


@case
def nms_mask(rs):
    chain = np.asarray([[0.0, 0.0, 0.4, 0.4], [0.2, 0.2, 0.6, 0.6],
                        [0.42, 0.42, 0.8, 0.8]], np.float32)
    got = op_parity(lambda b, s: JD.nms_mask(b, s, iou_threshold=0.1),
                    lambda b, s: TD.nms_mask(b, s, iou_threshold=0.1),
                    [chain, np.asarray([0.9, 0.8, 0.7], np.float32)],
                    exact=True)
    assert got[0].tolist() == [True, False, True]
    boxes = _gt(rs, 12)
    tied = np.round(rs.rand(12) * 3).astype(np.float32) / 3
    for scores in (rs.rand(12).astype(np.float32), tied):
        op_parity(JD.nms_mask, TD.nms_mask, [boxes, scores], exact=True)


@case
def detection_output(rs):
    priors = _priors()
    n = priors.shape[0]
    for c, top_k, thr in ((3, 40, 0.01), (2, 5, 0.3), (4, 20, 0.2)):
        # classes exact: those of the zero-score entries (suppressed,
        # under the threshold or padding) follow the stable order
        op_parity(
            lambda l, f: JD.detection_output(
                l, f, priors, num_classes=c, top_k=top_k,
                score_threshold=thr, pre_nms_top_k=10),
            lambda l, f: TD.detection_output(
                l, f, priors, num_classes=c, top_k=top_k,
                score_threshold=thr, pre_nms_top_k=10),
            [0.3 * np_f32(rs, n, 4), 2 * np_f32(rs, n, c)])


@case
def detection_output_ties(rs):
    # uniform class scores: every candidate ties, the order is the index's
    # (classes exact; scores and boxes at 1e-5)
    priors = _priors()
    n = priors.shape[0]
    op_parity(lambda l, f: JD.detection_output(l, f, priors, num_classes=3,
                                               top_k=50, pre_nms_top_k=12),
              lambda l, f: TD.detection_output(l, f, priors, num_classes=3,
                                               top_k=50, pre_nms_top_k=12),
              [np.zeros((n, 4), np.float32), np.zeros((n, 3), np.float32)])


# -- detection mAP --------------------------------------------------------------


def _map_records(rs, images=4, classes=3):
    out = []
    for _ in range(images):
        m = rs.randint(1, 4)
        gt = np.concatenate([rs.randint(1, classes, (m, 1)), _gt(rs, m)], 1)
        k = rs.randint(0, 6)
        boxes = np.concatenate([gt[:, 1:], _gt(rs, k)])[:k] if k else \
            np.zeros((0, 4))
        boxes = boxes + rs.uniform(-0.03, 0.03, boxes.shape)
        det = np.concatenate([rs.randint(0, classes, (len(boxes), 1)),
                              np.round(rs.rand(len(boxes), 1), 1), boxes], 1)
        out.append((det, gt))
    return out


@case
def detection_map_evaluator(rs):
    assert DetectionMAPEvaluator is TMD.DetectionMAPEvaluator
    records = _map_records(rs)
    for ap_type in ("11point", "integral"):
        for thr in (0.5, 0.3):
            want = JMD.DetectionMAPEvaluator(thr, ap_type)
            got = TMD.DetectionMAPEvaluator(thr, ap_type)
            for det, gt in records:
                want.update(det, gt)
                got.update(det, gt)
            assert got.result() == want.result()
            got.reset()
            assert got.result() == {"mAP": 0.0, "num_classes": 0.0}


@case
def iou_matrix(rs):
    a, b = _gt(rs, 5).astype(np.float64), _gt(rs, 3).astype(np.float64)
    np.testing.assert_array_equal(TMD.iou_matrix(a, b), JMD.iou_matrix(a, b))


@case
def average_precision(rs):
    scores = np.round(rs.rand(12), 1)
    tps = (rs.rand(12) > 0.4).astype(np.int64)
    for ap in ("11point", "integral"):
        for n_gt in (0, 5, 9):
            assert TMD.average_precision(scores, tps, n_gt, ap) == \
                JMD.average_precision(scores, tps, n_gt, ap)
    with pytest.raises(ValueError, match="ap_type"):
        TMD.average_precision(scores, tps, 3, "bogus")


@pytest.mark.parametrize("name", sorted(CASES))
def test_conv_detection_op_matches_jax(name):
    CASES[name](np.random.RandomState(sorted(CASES).index(name)))
