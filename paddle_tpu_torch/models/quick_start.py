"""The quick-start text classifiers (port of
`paddle_tpu.models.quick_start`): bag-of-words logistic regression, the
sequence-conv CNN, the bidirectional LSTM and the deep alternating
fc+LSTM stack (db_lstm). The plain LSTM classifier is
`models.text_lstm`.

All take dense padded [B, T] token batches and lengths [B] and return
logits [B, C]; `bow_lr` takes [B, V] count vectors. The LSTMs run
through `ops.rnn.lstm` (kernels D and E on CUDA tensors with impl None,
their plain versions on CPU tensors; `impl` picks as there); bow_lr and
text_cnn have no kernel.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.ops import sequence as seq_ops


def _fc(rng, fan_in: int, fan_out: int):
    return {"kernel": initializers.smart_uniform()(rng, (fan_in, fan_out)),
            "bias": torch.zeros(fan_out)}


def _on(params, dev):
    return tree_map(lambda t: t.to(dev), params)


# -- bag-of-words logistic regression ------------------------------------------


def init_bow_lr(rng, vocab_size: int, num_classes: int = 2, *, device=None):
    """{"fc": {kernel [V, C], bias}}. rng: an int seed, a numpy
    RandomState or a CPU torch.Generator (draws differ from
    `jax.random`'s); device None -> cuda (raises without one)."""
    dev = resolve_device(device)
    return _on({"fc": _fc(initializers.as_rng(rng), vocab_size,
                          num_classes)}, dev)


def bow_lr(params, bow):
    """bow: [B, V] count vectors -> logits [B, C]."""
    return linalg.dense(bow, params["fc"]["kernel"], params["fc"]["bias"])


def bow_lr_from_tokens(params, tokens, lengths):
    """The same model fed [B, T] token ids: the sum of each token's
    weight row (the count vector's product, at O(B*T) instead of
    O(B*V))."""
    t = tokens.shape[1]
    rows = params["fc"]["kernel"][tokens.long()]               # [B, T, C]
    mask = seq_ops.length_mask(lengths.to(rows.device), t)[..., None]
    return torch.sum(torch.where(mask, rows, 0.0), dim=1) + \
        params["fc"]["bias"]


# -- embedding -> sequence conv -> max pool ------------------------------------


def init_text_cnn(rng, vocab_size: int, num_classes: int = 2, *,
                  embed_dim: int = 128, context_len: int = 3,
                  hidden: int = 512, device=None):
    """{"embed", "conv": {filter [context_len * E, hidden], bias}, "fc"};
    rng and device as in init_bow_lr."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    return _on({
        "embed": initializers.normal(0.05)(rng, (vocab_size, embed_dim)),
        "conv": {"filter": initializers.smart_uniform()(
                     rng, (context_len * embed_dim, hidden)),
                 "bias": torch.zeros(hidden)},
        "fc": _fc(rng, hidden, num_classes),
    }, dev)


def text_cnn(params, tokens, lengths, *, context_len: int = 3):
    """Context-window conv (`ops.sequence.sequence_conv`), relu, max pool
    over time, fc."""
    x = params["embed"][tokens.long()]                         # [B, T, E]
    h = seq_ops.sequence_conv(x, lengths, params["conv"]["filter"],
                              context_len=context_len)
    h = torch.relu(h + params["conv"]["bias"])
    pooled = seq_ops.dense_sequence_pool(h, lengths, "max")
    return linalg.dense(pooled, params["fc"]["kernel"], params["fc"]["bias"])


# -- bidirectional LSTM --------------------------------------------------------


def init_bidi_lstm(rng, vocab_size: int, num_classes: int = 2, *,
                   embed_dim: int = 128, hidden: int = 128, device=None):
    """{"embed", "fwd", "bwd" (LSTMs), "fc" [2H, C]}; rng and device as in
    init_bow_lr."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    return _on({
        "embed": initializers.normal(0.05)(rng, (vocab_size, embed_dim)),
        "fwd": rnn_ops.init_lstm_params(rng, embed_dim, hidden),
        "bwd": rnn_ops.init_lstm_params(rng, embed_dim, hidden),
        "fc": _fc(rng, 2 * hidden, num_classes),
    }, dev)


def bidi_lstm(params, tokens, lengths, *, impl=None):
    """A forward and a reversed LSTM over the embeddings, their concat
    max-pooled over time, fc."""
    x = params["embed"][tokens.long()]
    out, _ = rnn_ops.bidirectional(rnn_ops.lstm, params["fwd"],
                                   params["bwd"], x, lengths, impl=impl)
    pooled = seq_ops.dense_sequence_pool(out, lengths, "max")
    return linalg.dense(pooled, params["fc"]["kernel"], params["fc"]["bias"])


# -- deep alternating fc + LSTM stack ------------------------------------------


def init_db_lstm(rng, vocab_size: int, num_classes: int = 2, *,
                 embed_dim: int = 128, hidden: int = 128, depth: int = 8,
                 device=None):
    """{"embed", "fc0" [E, H], "lstm0", then fc{i} [2H, H] and lstm{i}
    for i < depth, "out" [H, C]}; rng and device as in init_bow_lr."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    params = {
        "embed": initializers.normal(0.05)(rng, (vocab_size, embed_dim)),
        "fc0": _fc(rng, embed_dim, hidden),
        "lstm0": rnn_ops.init_lstm_params(rng, hidden, hidden),
    }
    for i in range(1, depth):
        params[f"fc{i}"] = _fc(rng, 2 * hidden, hidden)
        params[f"lstm{i}"] = rnn_ops.init_lstm_params(rng, hidden, hidden)
    params["out"] = _fc(rng, hidden, num_classes)
    return _on(params, dev)


def db_lstm(params, tokens, lengths, *, impl=None):
    """fc_i takes [fc_{i-1}, lstm_{i-1}] concatenated, lstm_i scans right
    to left where i is odd; the last LSTM's outputs are max-pooled over
    time. The depth is the count of lstm* levels in params."""
    depth = sum(1 for k in params if k.startswith("lstm"))
    x = params["embed"][tokens.long()]
    fc = torch.relu(linalg.dense(x, params["fc0"]["kernel"],
                                 params["fc0"]["bias"]))
    lstm_out, _ = rnn_ops.lstm(params["lstm0"], fc, lengths, impl=impl)
    for i in range(1, depth):
        inp = torch.cat([fc, lstm_out], dim=-1)
        fc = torch.relu(linalg.dense(inp, params[f"fc{i}"]["kernel"],
                                     params[f"fc{i}"]["bias"]))
        lstm_out, _ = rnn_ops.lstm(params[f"lstm{i}"], fc, lengths,
                                   reverse=(i % 2) == 1, impl=impl)
    pooled = seq_ops.dense_sequence_pool(lstm_out, lengths, "max")
    return linalg.dense(pooled, params["out"]["kernel"],
                        params["out"]["bias"])
