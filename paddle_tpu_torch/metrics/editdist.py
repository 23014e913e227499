"""Edit-distance / CTC error evaluator.

Reference: gserver/evaluators/CTCErrorEvaluator.cpp:318 — greedy CTC
decode (argmax, collapse repeats, drop blanks) then Levenshtein distance
against the label sequence, streamed as total-distance / total-label-len
(character error rate). The DP is sequential and ragged → host numpy;
the argmax runs in-graph upstream.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from paddle_tpu_torch.metrics.base import Evaluator


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance between two token sequences."""
    a, b = list(a), list(b)
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a, 1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
        prev = cur
    return int(prev[-1])


def ctc_greedy_decode(frame_ids: Sequence[int], blank: int = 0) -> List[int]:
    """Collapse repeats then drop blanks (best-path CTC decode)."""
    out: List[int] = []
    prev = None
    for t in frame_ids:
        t = int(t)
        if t != prev and t != blank:
            out.append(t)
        prev = t
    return out


class CTCErrorEvaluator(Evaluator):
    """Streaming sequence error rate: sum(edit_distance)/sum(label_len)
    (reference: CTCErrorEvaluator.cpp:318)."""

    name = "ctc_error"

    def __init__(self, blank: int = 0, decode: bool = True):
        self.blank = blank
        self.decode = decode
        self.reset()

    def reset(self) -> None:
        self._dist = 0
        self._len = 0
        self._seqs = 0
        self._wrong_seqs = 0

    def update(self, pred, labels, pred_lengths=None,
               label_lengths=None) -> None:
        """pred: [batch, time] frame-wise argmax ids (decode=True) or
        already-decoded id sequences; labels: [batch, max_label_len]."""
        pred = np.asarray(pred)
        labels = np.asarray(labels)
        if pred.ndim == 1:
            pred = pred[None]
            labels = labels[None]
        n = pred.shape[0]
        for i in range(n):
            p = pred[i]
            if pred_lengths is not None:
                p = p[: int(np.asarray(pred_lengths).reshape(-1)[i])]
            hyp = ctc_greedy_decode(p, self.blank) if self.decode else \
                [int(t) for t in p if int(t) != self.blank]
            ref = labels[i]
            if label_lengths is not None:
                ref = ref[: int(np.asarray(label_lengths).reshape(-1)[i])]
            ref = [int(t) for t in ref if int(t) != self.blank]
            d = edit_distance(hyp, ref)
            self._dist += d
            self._len += len(ref)
            self._seqs += 1
            self._wrong_seqs += int(d > 0)

    def result(self) -> Dict[str, float]:
        return {
            "error_rate": self._dist / max(self._len, 1),
            "seq_error_rate": self._wrong_seqs / max(self._seqs, 1),
            "total_distance": float(self._dist),
        }
