"""Stacked-LSTM text classifier (port of `paddle_tpu.models.text_lstm`):
embedding -> stacked LSTMs -> pooled features -> fc, over dense padded
[B, T] token batches and lengths [B]."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.ops import sequence as seq_ops


def init_params(rng, vocab_size: int, num_classes: int = 2, *,
                embed_dim: int = 64, hidden: int = 128, num_layers: int = 2,
                device=None):
    """The JAX package's tree ({"embed", "fc": {kernel, bias},
    "lstm{i}"}) and distributions. rng: an int seed, a numpy RandomState
    or a CPU torch.Generator (draws differ from `jax.random`'s). device
    None -> cuda (raises without one)."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    params = {
        "embed": initializers.normal(0.05)(rng, (vocab_size, embed_dim)),
        "fc": {
            "kernel": initializers.smart_uniform()(rng,
                                                   (hidden, num_classes)),
            "bias": torch.zeros(num_classes),
        },
    }
    in_dim = embed_dim
    for i in range(num_layers):
        params[f"lstm{i}"] = rnn_ops.init_lstm_params(rng, in_dim, hidden)
        in_dim = hidden
    return tree_map(lambda t: t.to(dev), params)


def apply(params, tokens, lengths, *, num_layers: int = 2, pool: str = "max",
          impl=None):
    """tokens: [B, T] int; lengths: [B]. Returns logits [B, C]. impl
    selects the LSTM time loop (see `ops.rnn.lstm`)."""
    x = params["embed"][tokens.long()]
    for i in range(num_layers):
        x, _ = rnn_ops.lstm(params[f"lstm{i}"], x, lengths, impl=impl)
    pooled = seq_ops.dense_sequence_pool(x, lengths, pool)
    return linalg.dense(pooled, params["fc"]["kernel"], params["fc"]["bias"])
