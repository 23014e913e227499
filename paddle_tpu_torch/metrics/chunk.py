"""Chunk (NER-style span) F1 evaluator.

Reference: gserver/evaluators/ChunkEvaluator.cpp:294 — streams
(num_correct, num_label_chunks, num_output_chunks) over IOB/IOE/IOBES
tag sequences and reports precision/recall/F1. Span extraction is
inherently sequential and ragged, so it runs host-side on numpy, as the
reference's did on CPU.

Tag encoding follows the reference: for a scheme with `tag_per_chunk`
positional tags, tag id = chunk_type * tag_per_chunk + pos, where pos
indexes into the scheme string (IOB: 0=B, 1=I; IOE: 0=I, 1=E; IOBES:
0=B, 1=I, 2=E, 3=S), and a single extra id
(num_chunk_types * tag_per_chunk) is "O" / outside.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.metrics.base import Evaluator

_SCHEMES = {
    "plain": 1,  # every tag is its own chunk type, no positions
    "IOB": 2,
    "IOE": 2,
    "IOBES": 4,
}


def extract_chunks(tags: Sequence[int], scheme: str,
                   num_chunk_types: int) -> List[Tuple[int, int, int]]:
    """Decode a tag sequence into chunks [(type, begin, end_exclusive)]."""
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown chunk scheme {scheme!r}")
    tpc = _SCHEMES[scheme]
    outside = num_chunk_types * tpc
    chunks: List[Tuple[int, int, int]] = []
    start = -1
    cur_type = -1

    def flush(end):
        nonlocal start, cur_type
        if start >= 0:
            chunks.append((cur_type, start, end))
        start, cur_type = -1, -1

    for i, t in enumerate(tags):
        t = int(t)
        if t == outside or t < 0:
            flush(i)
            continue
        ctype, pos = divmod(t, tpc)
        if scheme == "plain":
            # maximal runs of the same type
            if ctype != cur_type:
                flush(i)
                start, cur_type = i, ctype
        elif scheme == "IOB":
            begins = pos == 0 or ctype != cur_type or start < 0
            if begins:
                flush(i)
                start, cur_type = i, ctype
        elif scheme == "IOE":
            # I=0 continues, E=1 marks chunk end (reference:
            # ChunkEvaluator.cpp:89-94)
            if ctype != cur_type or start < 0:
                flush(i)
                start, cur_type = i, ctype
            if pos == 1:  # E
                flush(i + 1)
        elif scheme == "IOBES":
            if pos == 3:  # S: single-token chunk
                flush(i)
                chunks.append((ctype, i, i + 1))
            elif pos == 0:  # B
                flush(i)
                start, cur_type = i, ctype
            elif pos == 1:  # I
                if ctype != cur_type or start < 0:
                    flush(i)
                    start, cur_type = i, ctype
            else:  # E
                if ctype != cur_type or start < 0:
                    flush(i)
                    start, cur_type = i, ctype
                flush(i + 1)
    flush(len(tags))
    return chunks


class ChunkEvaluator(Evaluator):
    """Streaming chunk precision/recall/F1 (reference:
    ChunkEvaluator.cpp:294)."""

    name = "chunk_f1"

    def __init__(self, scheme: str = "IOB", num_chunk_types: int = 1):
        if scheme not in _SCHEMES:
            raise ValueError(f"unknown chunk scheme {scheme!r}")
        self.scheme = scheme
        self.num_chunk_types = num_chunk_types
        self.reset()

    def reset(self) -> None:
        self._correct = 0
        self._label = 0
        self._output = 0

    def update(self, pred_tags, label_tags, lengths=None) -> None:
        """pred_tags/label_tags: [batch, time] int arrays (or 1-D single
        sequence); lengths masks padding per row."""
        pred = np.asarray(pred_tags)
        lab = np.asarray(label_tags)
        if pred.ndim == 1:
            pred, lab = pred[None], lab[None]
            lengths = np.asarray([pred.shape[1]]) if lengths is None else \
                np.asarray(lengths).reshape(1)
        if lengths is None:
            lengths = np.full((pred.shape[0],), pred.shape[1])
        for row in range(pred.shape[0]):
            n = int(lengths[row])
            p = set(extract_chunks(pred[row, :n], self.scheme,
                                   self.num_chunk_types))
            g = set(extract_chunks(lab[row, :n], self.scheme,
                                   self.num_chunk_types))
            self._correct += len(p & g)
            self._output += len(p)
            self._label += len(g)

    def result(self) -> Dict[str, float]:
        precision = self._correct / max(self._output, 1)
        recall = self._correct / max(self._label, 1)
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0.0)
        return {"precision": precision, "recall": recall, "f1": f1}
