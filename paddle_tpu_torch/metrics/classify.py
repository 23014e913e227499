"""Classification-family streaming evaluators.

Reference: gserver/evaluators/Evaluator.cpp — classification_error,
precision_recall, rankauc (`AucEvaluator`), pnpair, sum/column-sum
evaluators (REGISTER_EVALUATOR sites Evaluator.cpp:172-1357).

Dense per-batch reductions (confusion matrix, AUC histograms) are torch
functions that run on the outputs' device (a fixed-length `bincount`),
so an eval step can reduce on the card and hand the evaluators small
arrays; the Evaluator objects themselves are numpy, on the host (the
port of `paddle_tpu.metrics.classify`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.metrics.base import Evaluator


def confusion_matrix(pred, labels, num_classes: int):
    """[num_classes, num_classes] int32 count matrix, rows = true class,
    on the inputs' device. Sum the outputs across batches, then hand the
    sum to PrecisionRecallEvaluator.update."""
    idx = (labels.reshape(-1).long() * num_classes
           + pred.reshape(-1).long())
    flat = torch.bincount(idx, minlength=num_classes * num_classes)
    return flat[:num_classes * num_classes].to(torch.int32).reshape(
        num_classes, num_classes)


class ClassificationErrorEvaluator(Evaluator):
    """Streaming error rate weighted by sample count (reference:
    Evaluator.cpp ClassificationErrorEvaluator)."""

    name = "classification_error"

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._wrong = 0.0
        self._total = 0.0

    def update(self, pred, labels) -> None:
        pred = np.asarray(pred)
        if pred.ndim > 1:  # logits
            pred = pred.argmax(-1)
        labels = np.asarray(labels).reshape(pred.shape)
        self._wrong += float((pred != labels).sum())
        self._total += float(pred.size)

    def result(self) -> float:
        return self._wrong / max(self._total, 1.0)


class PrecisionRecallEvaluator(Evaluator):
    """Per-class precision/recall/F1 + macro average from a streamed
    confusion matrix (reference: Evaluator.cpp PrecisionRecallEvaluator)."""

    name = "precision_recall"

    def __init__(self, num_classes: int, positive_label: Optional[int] = None):
        self.num_classes = num_classes
        self.positive_label = positive_label
        self.reset()

    def reset(self) -> None:
        self._cm = np.zeros((self.num_classes, self.num_classes), np.int64)

    def update(self, pred, labels=None) -> None:
        """Accepts either (pred/logits, labels) raw arrays or a
        pre-reduced confusion matrix via update(cm)."""
        if labels is None:
            self._cm += np.asarray(pred, np.int64)
            return
        pred = np.asarray(pred)
        if pred.ndim > 1:
            pred = pred.argmax(-1)
        labels = np.asarray(labels).reshape(pred.shape)
        cm = np.zeros_like(self._cm)
        np.add.at(cm, (labels.reshape(-1), pred.reshape(-1)), 1)
        self._cm += cm

    def result(self) -> Dict[str, float]:
        cm = self._cm.astype(np.float64)
        tp = np.diag(cm)
        precision = tp / np.maximum(cm.sum(0), 1.0)
        recall = tp / np.maximum(cm.sum(1), 1.0)
        f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-12)
        if self.positive_label is not None:
            k = self.positive_label
            return {
                "precision": float(precision[k]),
                "recall": float(recall[k]),
                "f1": float(f1[k]),
            }
        # macro over classes that actually appear (reference averages over
        # classes with any support)
        support = cm.sum(1) > 0
        n = max(int(support.sum()), 1)
        return {
            "precision": float(precision[support].sum() / n),
            "recall": float(recall[support].sum() / n),
            "f1": float(f1[support].sum() / n),
        }


def auc_histograms(scores, labels, num_buckets: int = 4096):
    """Per-batch reduction for AUC on the inputs' device: bucketed
    positive/negative score histograms (int32 [num_buckets] each, the
    same fixed-bucket scheme as AucEvaluator). scores in [0, 1]."""
    b = torch.clamp((scores.reshape(-1) * num_buckets).to(torch.int32), 0,
                    num_buckets - 1).long()
    lab = labels.reshape(-1).to(torch.int32)
    count = lambda w: torch.bincount(b, weights=w.double(),
                                     minlength=num_buckets).to(torch.int32)
    return count(lab), count(1 - lab)


class AucEvaluator(Evaluator):
    """Streaming ROC-AUC via score histograms (reference: Evaluator.cpp
    AucEvaluator / rankauc)."""

    name = "auc"

    def __init__(self, num_buckets: int = 4096):
        self.num_buckets = num_buckets
        self.reset()

    def reset(self) -> None:
        self._pos = np.zeros((self.num_buckets,), np.int64)
        self._neg = np.zeros((self.num_buckets,), np.int64)

    def update(self, scores, labels=None) -> None:
        """update(scores, labels) with raw arrays, or update((pos, neg))
        with histograms from auc_histograms."""
        if labels is None:
            pos, neg = scores
            self._pos += np.asarray(pos, np.int64)
            self._neg += np.asarray(neg, np.int64)
            return
        scores = np.asarray(scores, np.float64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        b = np.clip((scores * self.num_buckets).astype(np.int64), 0,
                    self.num_buckets - 1)
        np.add.at(self._pos, b, labels != 0)
        np.add.at(self._neg, b, labels == 0)

    def result(self) -> float:
        # trapezoid over buckets ascending by score: pairs won = for each
        # positive, negatives in strictly lower buckets + half of ties
        pos, neg = self._pos.astype(np.float64), self._neg.astype(np.float64)
        neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
        won = (pos * (neg_below + 0.5 * neg)).sum()
        total = pos.sum() * neg.sum()
        return float(won / total) if total > 0 else 0.5


class PnPairEvaluator(Evaluator):
    """Positive-negative pair ordering ratio grouped by query id
    (reference: Evaluator.cpp PnpairEvaluator): over all (pos, neg) pairs
    within a query, fraction scored in the right order."""

    name = "pnpair"

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._records = []  # (query_id, score, label)

    def update(self, scores, labels, query_ids) -> None:
        scores = np.asarray(scores, np.float64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        query_ids = np.asarray(query_ids).reshape(-1)
        self._records.append((query_ids, scores, labels))

    def result(self) -> Dict[str, float]:
        if not self._records:
            return {"right": 0.0, "wrong": 0.0, "ratio": 0.0}
        qid = np.concatenate([r[0] for r in self._records])
        score = np.concatenate([r[1] for r in self._records])
        label = np.concatenate([r[2] for r in self._records])
        right = wrong = tie = 0.0
        for q in np.unique(qid):
            m = qid == q
            s, l = score[m], label[m]
            pos, neg = s[l != 0], s[l == 0]
            if len(pos) == 0 or len(neg) == 0:
                continue
            # sort+searchsorted pair counting: O(n log n), no dense
            # pos×neg matrix
            neg_sorted = np.sort(neg)
            below = np.searchsorted(neg_sorted, pos, side="left")
            below_or_eq = np.searchsorted(neg_sorted, pos, side="right")
            right += float(below.sum())
            tie += float((below_or_eq - below).sum())
            wrong += float((len(neg) - below_or_eq).sum())
        denom = max(right + wrong + tie, 1.0)
        return {"right": right, "wrong": wrong,
                "ratio": (right + 0.5 * tie) / denom}


class SumEvaluator(Evaluator):
    """Streaming sum of a scalar/vector output (reference: Evaluator.cpp
    SumEvaluator)."""

    name = "sum"

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._sum = 0.0

    def update(self, values, *_unused) -> None:
        self._sum += float(np.asarray(values, np.float64).sum())

    def result(self) -> float:
        return self._sum


class ColumnSumEvaluator(Evaluator):
    """Per-column mean of a [batch, d] output (reference: Evaluator.cpp
    ColumnSumEvaluator)."""

    name = "column_sum"

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._sum = None
        self._n = 0

    def update(self, values, *_unused) -> None:
        v = np.asarray(values, np.float64)
        v = v.reshape(v.shape[0], -1)
        self._sum = v.sum(0) if self._sum is None else self._sum + v.sum(0)
        self._n += v.shape[0]

    def result(self):
        if self._sum is None:
            return None
        return self._sum / max(self._n, 1)
