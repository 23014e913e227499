"""Printer evaluators — debugging evaluators that print values instead of
scoring them (reference: gserver/evaluators/Evaluator.cpp:1357 area —
value_printer, seq_text_printer, classification_error_printer;
trainer_config_helpers/evaluators.py wrappers). Port of
`paddle_tpu.metrics.printer`: the arrays are read on the host, a tensor
through `.detach().cpu()` (np.asarray of a CUDA tensor raises).
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.metrics.base import Evaluator


def host_array(x) -> np.ndarray:
    """x as a host numpy array: a tensor through .detach().cpu() (bf16
    widened to f32, which numpy holds), anything else np.asarray."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class ValuePrinter(Evaluator):
    """Print (a summary of) the arrays passed each batch (reference:
    value_printer_evaluator). summarize=True prints shape/mean/std
    instead of full contents."""

    name = "value_printer"

    def __init__(self, *, summarize: bool = True, max_items: int = 8,
                 stream=None):
        self.summarize = summarize
        self.max_items = max_items
        self.stream = stream or sys.stdout
        self._batch = 0

    def reset(self) -> None:
        self._batch = 0

    def update(self, *arrays, **named) -> None:
        items = list(enumerate(arrays)) + sorted(named.items())
        for key, arr in items:
            a = host_array(arr)
            if self.summarize:
                self.stream.write(
                    f"[value_printer] batch {self._batch} {key}: "
                    f"shape={a.shape} dtype={a.dtype} "
                    f"mean={a.mean():.6g} std={a.std():.6g} "
                    f"min={a.min():.6g} max={a.max():.6g}\n")
            else:
                flat = a.reshape(-1)[: self.max_items]
                self.stream.write(
                    f"[value_printer] batch {self._batch} {key}: "
                    f"{np.array2string(flat, precision=4)}"
                    f"{'...' if a.size > self.max_items else ''}\n")
        self._batch += 1

    def result(self) -> int:
        return self._batch


class SeqTextPrinter(Evaluator):
    """Map id sequences back to tokens and print them (reference:
    seq_text_printer / gserver SequenceTextPrinter) — the debugging aid
    for generation outputs.

    vocab: id -> str mapping (dict or sequence). update(ids, lengths)
    takes [B, T] int ids; stops each row at its length (or eos_id).
    """

    name = "seq_text_printer"

    def __init__(self, vocab, *, eos_id: Optional[int] = None,
                 sep: str = " ", stream=None):
        self._lookup: Callable[[int], str]
        if isinstance(vocab, dict):
            self._lookup = lambda i: str(vocab.get(i, f"<{i}>"))
        else:
            seq = list(vocab)
            self._lookup = lambda i: (
                str(seq[i]) if 0 <= i < len(seq) else f"<{i}>")
        self.eos_id = eos_id
        self.sep = sep
        self.stream = stream or sys.stdout
        self._count = 0

    def reset(self) -> None:
        self._count = 0

    def update(self, ids, lengths=None) -> None:
        ids = host_array(ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        for row_i, row in enumerate(ids):
            if lengths is not None:
                row = row[: int(host_array(lengths).reshape(-1)[row_i])]
            elif self.eos_id is not None:
                stop = np.nonzero(row == self.eos_id)[0]
                if stop.size:
                    row = row[: stop[0] + 1]
            text = self.sep.join(self._lookup(int(t)) for t in row)
            self.stream.write(f"[seq {self._count}] {text}\n")
            self._count += 1

    def result(self) -> int:
        return self._count


def parameter_stats(params, grads=None) -> Dict[str, Dict[str, float]]:
    """Per-parameter magnitude summary — the showParameterStats dump
    (reference: trainer/TrainerInternal.cpp:186-215 prints max/avg of
    each parameter's value and gradient every
    show_parameter_stats_period batches)."""
    out: Dict[str, Dict[str, float]] = {}

    def visit(name, leaf, grad_leaf=None):
        a = host_array(leaf)
        rec = {
            "shape": list(a.shape),
            "mean": float(a.mean()),
            "abs_mean": float(np.abs(a).mean()),
            "max": float(a.max()),
            "min": float(a.min()),
            "l2": float(np.sqrt((a.astype(np.float64) ** 2).sum())),
        }
        if grad_leaf is not None:
            g = host_array(grad_leaf)
            rec["grad_abs_mean"] = float(np.abs(g).mean())
            rec["grad_max"] = float(np.abs(g).max())
        out[name] = rec
        return leaf

    flat_g = dict(_named_leaves(grads)) if grads is not None else {}
    for name, leaf in _named_leaves(params):
        visit(name, leaf, flat_g.get(name))
    return out


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def format_parameter_stats(stats: Dict[str, Dict[str, float]]) -> str:
    lines = [f"{'parameter':40s} {'shape':>14s} {'abs_mean':>10s} "
             f"{'max':>10s} {'l2':>10s}"]
    for name, s in stats.items():
        lines.append(
            f"{name[:40]:40s} {str(tuple(s['shape'])):>14s} "
            f"{s['abs_mean']:10.4g} {s['max']:10.4g} {s['l2']:10.4g}")
    return "\n".join(lines)
