"""In-graph metric ops (port of `paddle_tpu.ops.metrics`): they run on
the outputs' device inside a step; streaming aggregation across batches
lives in `metrics/`. `torch.argmax` keeps the first maximum, as
`jnp.argmax` does, and the top-k ids come from a stable descending sort,
so tied logits keep the lower index first, as `jnp.argsort(-logits)`."""

from __future__ import annotations

import torch


def accuracy(logits, labels):
    """Top-1 accuracy (f32 scalar)."""
    pred = torch.argmax(logits, dim=-1)
    return torch.mean((pred == labels).to(torch.float32))


def classification_error(logits, labels):
    """1 - accuracy."""
    return 1.0 - accuracy(logits, labels)


def top_k_accuracy(logits, labels, k: int = 5):
    """The share of rows whose label is among their k highest logits."""
    topk = torch.sort(-logits, dim=-1, stable=True).indices[..., :k]
    hit = torch.any(topk == labels[..., None], dim=-1)
    return torch.mean(hit.to(torch.float32))
