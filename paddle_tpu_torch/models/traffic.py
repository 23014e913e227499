"""Traffic-speed multi-task forecaster (port of
`paddle_tpu.models.traffic`): a link-encode vector through ONE shared
fc, then one 4-class softmax head per forecast horizon, trained jointly.
The per-horizon heads are one stacked [T, emb, 4] tensor applied with a
single einsum; the multi-task loss is the mean over horizons."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.ops import losses


def init_params(rng, *, term_num: int = 24, forecasting_num: int = 24,
                emb_size: int = 16, num_classes: int = 4, device=None):
    """{"link_vec": {kernel [term_num, emb] uniform in [-1, 1], bias},
    "heads": {kernel [forecasting_num, emb, classes], bias}}. rng: an
    int seed, a numpy RandomState or a CPU torch.Generator (draws differ
    from `jax.random`'s); device None -> cuda (raises without one)."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    params = {
        "link_vec": {
            "kernel": initializers.uniform(1.0)(rng, (term_num, emb_size)),
            "bias": torch.zeros(emb_size),
        },
        "heads": {
            "kernel": initializers.smart_uniform()(
                rng, (forecasting_num, emb_size, num_classes)),
            "bias": torch.zeros(forecasting_num, num_classes),
        },
    }
    return tree_map(lambda t: t.to(dev), params)


def apply(params, x):
    """x [B, term_num] speed history -> logits [B, tasks, classes]."""
    link = x @ params["link_vec"]["kernel"] + params["link_vec"]["bias"]
    return (torch.einsum("be,tec->btc", link, params["heads"]["kernel"])
            + params["heads"]["bias"])


def loss(params, x, labels):
    """Joint multi-task loss; labels [B, tasks] int, a class per
    horizon."""
    return torch.mean(losses.softmax_cross_entropy(apply(params, x), labels))


def predict(params, x):
    """Per-horizon argmax class [B, tasks]."""
    return torch.argmax(apply(params, x), dim=-1)
