"""Losses (port of `paddle_tpu.ops.losses.softmax_cross_entropy`,
`sigmoid_cross_entropy` and `chunked_lm_head_nll`; the other losses come
with the models that use them)."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.dtypes import at_least_f32
from paddle_tpu_torch.ops import linalg


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


def sigmoid_cross_entropy(logits, labels):
    """Element-wise binary CE from logits, in the numerically stable
    form max(x, 0) - x * y + log1p(exp(-|x|)) (at least f32)."""
    logits = at_least_f32(logits)
    labels = at_least_f32(labels)
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def chunked_lm_head_nll(hidden, kernel, targets, *, chunk: int = 2048,
                        bias=None):
    """Next-token NLL fused with the LM-head matmul, never holding the
    full [N, V] logits.

    The N = B*T positions (padded to whole chunks) go through the head
    `chunk` rows at a time, each chunk inside `torch.utils.checkpoint`:
    the forward keeps only the per-position nll, and the backward
    recomputes a chunk's logits right before it consumes them.

    hidden [B, T, D] (compute dtype), kernel [D, V], targets [B, T] int,
    bias optional [V]. Returns per-position nll [B, T] f32 (logits in
    at least f32, logsumexp minus the gold logit)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    b, t, d = hidden.shape
    n = b * t
    h = hidden.reshape(n, d)
    y = targets.reshape(n).long()
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        h = torch.cat([h, h.new_zeros((pad, d))])
        y = torch.cat([y, y.new_zeros((pad,))])

    def body(hc, yc):
        logits = at_least_f32(linalg.matmul(hc, kernel))
        if bias is not None:
            logits = logits + at_least_f32(bias)[None, :]
        # the gold logit keeps its last dim until the subtraction (a
        # vocab-sharded DTensor's gather is a masked partial sum whose
        # mask has the gather's shape)
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        gold = torch.gather(logits, 1, yc[:, None])
        return (lse - gold)[:, 0]

    grad = torch.is_grad_enabled()
    nll = []
    for i in range(n_chunks):
        rows = slice(i * chunk, (i + 1) * chunk)
        nll.append(checkpoint(body, h[rows], y[rows], use_reentrant=False)
                   if grad else body(h[rows], y[rows]))
    return torch.cat(nll)[:n].reshape(b, t)
