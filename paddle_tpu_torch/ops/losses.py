"""Losses (port of `paddle_tpu.ops.losses.softmax_cross_entropy`; the
other losses come with the models that use them)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtypes import at_least_f32


def softmax_cross_entropy(logits, labels, *, label_smoothing: float = 0.0):
    """Integer-label softmax CE. logits [..., C], labels [...] int ->
    per-example loss [...] (at least f32)."""
    num_classes = logits.shape[-1]
    log_p = torch.log_softmax(at_least_f32(logits), dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).to(
        log_p.dtype)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + \
            label_smoothing / num_classes
    return -torch.sum(onehot * log_p, dim=-1)
