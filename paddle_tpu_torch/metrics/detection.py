"""Detection mAP evaluator (a copy of `paddle_tpu.metrics.detection`,
which is framework-free: host numpy).

Reference: gserver/evaluators/DetectionMAPEvaluator.cpp:306 — streams
per-class detection records (score, tp/fp after IoU matching against
ground truth) and reports mean average precision, with both 11-point
interpolated and integral AP (the reference's `ap_type`). Matching is
ragged and per-image → host numpy, as in the reference.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np

from paddle_tpu_torch.metrics.base import Evaluator


def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """IoU between [N,4] and [M,4] boxes in (x1, y1, x2, y2)."""
    a = boxes_a[:, None, :]
    b = boxes_b[None, :, :]
    ix = np.maximum(
        0.0, np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]))
    iy = np.maximum(
        0.0, np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]))
    inter = ix * iy
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.maximum(area_a + area_b - inter, 1e-10)


def average_precision(scores: np.ndarray, tps: np.ndarray, num_gt: int,
                      ap_type: str = "11point") -> float:
    """AP from per-detection (score, is-true-positive) records."""
    if num_gt == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tps[order].astype(np.float64)
    fp = 1.0 - tp
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / num_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-10)
    if ap_type == "11point":
        ap = 0.0
        for r in np.linspace(0, 1, 11):
            mask = recall >= r
            ap += precision[mask].max() if mask.any() else 0.0
        return ap / 11.0
    if ap_type == "integral":
        # integrate precision over recall increments
        prev_r = 0.0
        ap = 0.0
        for p, r in zip(precision, recall):
            ap += p * (r - prev_r)
            prev_r = r
        return float(ap)
    raise ValueError(f"unknown ap_type {ap_type!r}")


class DetectionMAPEvaluator(Evaluator):
    """Streaming mAP (reference: DetectionMAPEvaluator.cpp:306)."""

    name = "detection_map"

    def __init__(self, overlap_threshold: float = 0.5,
                 ap_type: str = "11point", background_id: int = 0):
        self.overlap_threshold = overlap_threshold
        self.ap_type = ap_type
        self.background_id = background_id
        self.reset()

    def reset(self) -> None:
        self._records = defaultdict(lambda: ([], []))  # cls -> (scores, tps)
        self._num_gt = defaultdict(int)

    def update(self, detections, ground_truth) -> None:
        """detections: [N, 6] rows (class, score, x1, y1, x2, y2) for ONE
        image; ground_truth: [M, 5] rows (class, x1, y1, x2, y2)."""
        det = np.asarray(detections, np.float64).reshape(-1, 6)
        gt = np.asarray(ground_truth, np.float64).reshape(-1, 5)
        for row in gt:
            if int(row[0]) != self.background_id:
                self._num_gt[int(row[0])] += 1
        for cls in np.unique(det[:, 0]).astype(int):
            if cls == self.background_id:
                continue
            d = det[det[:, 0] == cls]
            d = d[np.argsort(-d[:, 1], kind="stable")]
            g = gt[gt[:, 0] == cls][:, 1:]
            matched = np.zeros(len(g), bool)
            scores, tps = self._records[cls]
            if len(g):
                ious = iou_matrix(d[:, 2:], g)
            for i in range(len(d)):
                scores.append(d[i, 1])
                if len(g) == 0:
                    tps.append(0)
                    continue
                j = int(ious[i].argmax())
                if ious[i, j] >= self.overlap_threshold and not matched[j]:
                    matched[j] = True
                    tps.append(1)
                else:
                    tps.append(0)

    def result(self) -> Dict[str, float]:
        aps = []
        for cls, n_gt in self._num_gt.items():
            scores, tps = self._records.get(cls, ([], []))
            aps.append(average_precision(
                np.asarray(scores), np.asarray(tps), n_gt, self.ap_type))
        return {"mAP": float(np.mean(aps)) if aps else 0.0,
                "num_classes": float(len(aps))}
