"""SSD-style detection ops (port of `paddle_tpu.ops.detection`): prior
boxes, box coding, IoU, prior-to-GT matching, the multibox loss with
hard negative mining, the masked NMS and the detection output.

Everything is fixed-shape and mask-based, as in the JAX package: matches
are per-prior indices with -1 sentinels, the mining is a rank mask, and
NMS runs a fixed number of fixed-point iterations on the device (no host
read ends it early). Boxes are (x1, y1, x2, y2) normalized to [0, 1].

Tie order follows JAX's: `torch.argmax` keeps the first maximum, and the
sorts that stand for `jnp.argsort` and `jax.lax.top_k` are stable
(`torch.topk` promises no tie order on CUDA), so tied scores -- the
detection output's zero padding, above all -- keep the lower index
first. Two GTs that share a best prior resolve to the higher index
through a max-reduction, not a scatter with duplicate indices.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.ops import losses


def prior_boxes(feature_hw: Tuple[int, int], image_hw: Tuple[int, int],
                min_sizes: Sequence[float], max_sizes: Sequence[float] = (),
                aspect_ratios: Sequence[float] = (2.0,),
                *, flip: bool = True, clip: bool = True) -> np.ndarray:
    """The anchor grid of one feature map: [H*W*A, 4] float32 corners,
    normalized (numpy: priors are static per config)."""
    fh, fw = feature_hw
    ih, iw = image_hw
    step_x, step_y = 1.0 / fw, 1.0 / fh
    ratios = [1.0]
    for r in aspect_ratios:
        ratios.append(r)
        if flip:
            ratios.append(1.0 / r)
    boxes = []
    for y in range(fh):
        for x in range(fw):
            cx, cy = (x + 0.5) * step_x, (y + 0.5) * step_y
            for k, ms in enumerate(min_sizes):
                bw, bh = ms / iw, ms / ih
                boxes.append([cx - bw / 2, cy - bh / 2,
                              cx + bw / 2, cy + bh / 2])
                if k < len(max_sizes):
                    s = float(np.sqrt(ms * max_sizes[k]))
                    bw, bh = s / iw, s / ih
                    boxes.append([cx - bw / 2, cy - bh / 2,
                                  cx + bw / 2, cy + bh / 2])
                for r in ratios:
                    if abs(r - 1.0) < 1e-6:
                        continue
                    bw = ms * np.sqrt(r) / iw
                    bh = ms / np.sqrt(r) / ih
                    boxes.append([cx - bw / 2, cy - bh / 2,
                                  cx + bw / 2, cy + bh / 2])
    out = np.asarray(boxes, np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return out


def _corner_to_center(b):
    return (b[..., 2:] + b[..., :2]) / 2, b[..., 2:] - b[..., :2]


def _variances(variances, like):
    return torch.as_tensor(variances, dtype=like.dtype, device=like.device)


def encode_boxes(gt, priors, variances=(0.1, 0.1, 0.2, 0.2)):
    """GT corners -> regression targets relative to the priors."""
    priors = torch.as_tensor(priors, device=gt.device)
    pc, pwh = _corner_to_center(priors)
    gc, gwh = _corner_to_center(gt)
    v = _variances(variances, gt)
    d_center = (gc - pc) / (pwh * v[:2])
    d_size = torch.log(torch.clamp(gwh / pwh, min=1e-8)) / v[2:]
    return torch.cat([d_center, d_size], dim=-1)


def decode_boxes(deltas, priors, variances=(0.1, 0.1, 0.2, 0.2)):
    """Inverse of encode_boxes."""
    priors = torch.as_tensor(priors, device=deltas.device)
    pc, pwh = _corner_to_center(priors)
    v = _variances(variances, deltas)
    c = deltas[..., :2] * v[:2] * pwh + pc
    wh = torch.exp(deltas[..., 2:] * v[2:]) * pwh
    return torch.cat([c - wh / 2, c + wh / 2], dim=-1)


def iou(boxes_a, boxes_b):
    """Pairwise IoU [N, M] of corner boxes."""
    a, b = boxes_a[:, None], boxes_b[None, :]
    ix = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                     - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    iy = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                     - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = ix * iy
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-10)


def match_priors(priors, gt_boxes, gt_valid, threshold: float = 0.5):
    """Every valid GT takes its best prior; the other priors take their
    best GT where its IoU >= threshold. gt_boxes [M, 4] padded, gt_valid
    [M] bool -> match [N] int64 (a GT index or -1). Two GTs sharing a best
    prior resolve to the higher index."""
    priors = torch.as_tensor(priors, device=gt_boxes.device)
    n, m = priors.shape[0], gt_boxes.shape[0]
    ious = iou(priors, gt_boxes)                          # [N, M]
    ious = torch.where(gt_valid[None, :], ious, torch.full_like(ious, -1.0))
    best_gt = torch.argmax(ious, dim=1)
    best_gt_iou = torch.amax(ious, dim=1)
    match = torch.where(best_gt_iou >= threshold, best_gt,
                        torch.full_like(best_gt, -1))
    best_prior = torch.argmax(ious, dim=0)                # [M]
    ar = lambda k: torch.arange(k, device=ious.device)
    hit = gt_valid[None, :] & (best_prior[None, :] == ar(n)[:, None])
    forced = torch.amax(torch.where(hit, ar(m)[None, :], -1), dim=1)
    return torch.where(forced >= 0, forced, match)


def _ranks(order):
    """rank[order[i]] = i."""
    return torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))


def multibox_loss(loc_preds, conf_logits, priors, gt_boxes, gt_labels,
                  gt_valid, *, overlap_threshold: float = 0.5,
                  neg_pos_ratio: float = 3.0, background_id: int = 0,
                  variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training loss of ONE image: (smooth-L1 over the matched
    priors + softmax CE over the matched priors and the hardest
    negatives, neg_pos_ratio per positive) / the number of positives.
    loc_preds [N, 4], conf_logits [N, C], priors [N, 4], gt_boxes
    [M, 4], gt_labels [M], gt_valid [M] bool. The negatives are ranked
    by a stable sort of their background loss."""
    priors = torch.as_tensor(priors, device=loc_preds.device)
    match = match_priors(priors, gt_boxes, gt_valid, overlap_threshold)
    pos = match >= 0
    num_pos = torch.clamp(pos.sum(), min=1)
    safe = torch.clamp(match, min=0)
    target = encode_boxes(gt_boxes[safe], priors, variances)
    loc_l = losses.smooth_l1(loc_preds, target)
    loc_loss = torch.where(pos, loc_l, 0.0).sum()
    labels = torch.where(pos, gt_labels.long()[safe],
                         torch.full_like(safe, background_id))
    logp = torch.log_softmax(conf_logits, dim=-1)
    ce = -torch.gather(logp, 1, labels[:, None])[:, 0]
    neg_score = torch.where(pos, float("-inf"), -logp[:, background_id])
    k = torch.clamp((neg_pos_ratio * num_pos).to(torch.int32),
                    max=pos.shape[0])
    rank = _ranks(torch.sort(-neg_score, stable=True).indices)
    neg = (~pos) & (rank < k) & torch.isfinite(neg_score)
    conf_loss = torch.where(pos | neg, ce, 0.0).sum()
    return (loc_loss + conf_loss) / num_pos


def nms_mask(boxes, scores, *, iou_threshold: float = 0.45):
    """Masked O(k^2) NMS over a fixed candidate set: bool [K] keep mask.
    Box i suppresses box j when it outranks it (a higher score, or an
    equal one at a lower index) and their IoU exceeds the threshold; K
    fixed-point iterations (a box stays iff no kept box suppresses it)
    resolve the chains. The scores need not be sorted."""
    k = boxes.shape[0]
    rank = torch.arange(k, device=boxes.device)
    higher = scores[:, None] > scores[None, :]
    tie = (scores[:, None] == scores[None, :]) & (rank[:, None]
                                                  < rank[None, :])
    suppressor = ((higher | tie) & (iou(boxes, boxes) > iou_threshold)).to(
        torch.float32)
    keep = torch.ones(k, dtype=torch.bool, device=boxes.device)
    for _ in range(k):
        keep = ~(keep.to(torch.float32) @ suppressor > 0)
    return keep


def _top_k(x, k):
    """(values, indices) of the k largest, ties to the lower index (a
    stable descending sort, as jax.lax.top_k)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def detection_output(loc_preds, conf_logits, priors, *,
                     num_classes: int, background_id: int = 0,
                     score_threshold: float = 0.01,
                     iou_threshold: float = 0.45, top_k: int = 100,
                     pre_nms_top_k: int = 200,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Decode and per-class NMS for ONE image: (classes [top_k], scores
    [top_k], boxes [top_k, 4]), zero scores padding. Per class the
    pre_nms_top_k best candidates enter NMS."""
    boxes = decode_boxes(loc_preds, priors, variances)          # [N, 4]
    probs = torch.softmax(conf_logits, dim=-1)                   # [N, C]
    cap = min(pre_nms_top_k, boxes.shape[0])
    dev = boxes.device
    all_scores, all_classes, all_boxes = [], [], []
    for c in range(num_classes):
        if c == background_id:
            continue
        s_top, idx = _top_k(probs[:, c], cap)
        cboxes = boxes[idx]
        keep = nms_mask(cboxes, s_top, iou_threshold=iou_threshold)
        all_scores.append(torch.where(keep & (s_top >= score_threshold),
                                      s_top, 0.0))
        all_classes.append(torch.full((cap,), c, dtype=torch.long,
                                      device=dev))
        all_boxes.append(cboxes)
    scores = torch.cat(all_scores)
    classes = torch.cat(all_classes)
    boxes_cat = torch.cat(all_boxes)
    if scores.shape[0] < top_k:
        padn = top_k - scores.shape[0]
        scores = torch.cat([scores, scores.new_zeros(padn)])
        classes = torch.cat([classes, classes.new_zeros(padn)])
        boxes_cat = torch.cat([boxes_cat, boxes_cat.new_zeros((padn, 4))])
    vals, idx = _top_k(scores, top_k)
    return classes[idx], vals, boxes_cat[idx]
