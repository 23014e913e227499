"""Semantic-role labeling: a depth-8 alternating-direction db-LSTM with
a CRF on top (port of `paddle_tpu.models.srl`, the label-semantic-roles
book chapter's network).

Eight input features -- the word and five context windows through one
shared word table, the predicate table, a 2-way mark table -- are
gathered as one [B, T, 6] index into the word table and concatenated,
so the per-feature fcs summed into hidden_0 are one [6D + D + Dm, H]
product. Layer i > 0 mixes fc(prev_mix) + fc(prev_lstm) as one fc over
their concat, and its LSTM scans right to left where i is odd (the db
in db-LSTM). The emissions fc(last_mix) + fc(last_lstm) feed a
linear-chain CRF (`ops.crf`).

The LSTMs run through `ops.rnn.lstm`: with impl None kernels D and E on
CUDA tensors (reversed layers as time-flipped inputs with [T-len, T)
bounds), their plain versions on CPU tensors; the CRF's dynamic
programs are torch ops.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import rnn as rnn_ops

N_WORD_FEATURES = 6  # word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2


def init_params(rng, word_vocab: int, pred_vocab: int, num_labels: int, *,
                word_dim: int = 32, mark_dim: int = 5, hidden: int = 64,
                depth: int = 8, device=None):
    """The JAX package's tree ({word_table, pred_table, mark_table,
    hidden0, lstm0, emit, crf: {start, end, trans}, mix{i}, lstm{i}})
    and distributions. rng: an int seed, a numpy RandomState or a CPU
    torch.Generator (draws differ from `jax.random`'s). device None ->
    cuda (raises without one)."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    emb = initializers.normal(0.05)
    fc = initializers.smart_uniform()
    in_dim = N_WORD_FEATURES * word_dim + word_dim + mark_dim
    params = {
        "word_table": emb(rng, (word_vocab, word_dim)),
        "pred_table": emb(rng, (pred_vocab, word_dim)),
        "mark_table": emb(rng, (2, mark_dim)),
        "hidden0": {"kernel": fc(rng, (in_dim, hidden)),
                    "bias": torch.zeros(hidden)},
        "lstm0": rnn_ops.init_lstm_params(rng, hidden, hidden),
        "emit": {"kernel": fc(rng, (2 * hidden, num_labels)),
                 "bias": torch.zeros(num_labels)},
        "crf": crf_ops.init_crf_params(rng, num_labels,
                                       device="cpu")._asdict(),
    }
    for i in range(1, depth):
        params[f"mix{i}"] = {"kernel": fc(rng, (2 * hidden, hidden)),
                             "bias": torch.zeros(hidden)}
        params[f"lstm{i}"] = rnn_ops.init_lstm_params(rng, hidden, hidden)
    return tree_map(lambda t: t.to(dev), params)


def _depth(params) -> int:
    return 1 + sum(1 for k in params if k.startswith("mix"))


def emissions(params, word_windows, predicate, mark, lengths, *, impl=None):
    """word_windows [B, T, 6] int (the 6 word-feature columns);
    predicate, mark [B, T] int; lengths [B]. Returns [B, T, L]. impl
    selects the LSTMs' time loop (see `ops.rnn.lstm`)."""
    b, t, _ = word_windows.shape
    w = params["word_table"][word_windows.long()]              # [B,T,6,D]
    p = params["pred_table"][predicate.long()]                 # [B,T,D]
    m = params["mark_table"][mark.long()]                      # [B,T,Dm]
    feats = torch.cat([w.reshape(b, t, -1), p, m], dim=-1)
    mix = linalg.dense(feats, params["hidden0"]["kernel"],
                       params["hidden0"]["bias"])
    out, _ = rnn_ops.lstm(params["lstm0"], mix, lengths, impl=impl)
    for i in range(1, _depth(params)):
        # fc(prev_mix) + fc(prev_lstm) == one fc over their concat
        mix = linalg.dense(torch.cat([mix, out], dim=-1),
                           params[f"mix{i}"]["kernel"],
                           params[f"mix{i}"]["bias"])
        # alternate the scan direction per layer
        out, _ = rnn_ops.lstm(params[f"lstm{i}"], mix, lengths,
                              reverse=(i % 2 == 1), impl=impl)
    return linalg.dense(torch.cat([mix, out], dim=-1),
                        params["emit"]["kernel"], params["emit"]["bias"])


def loss(params, word_windows, predicate, mark, labels, lengths, *,
         impl=None):
    """Mean negative CRF log-likelihood. labels [B, T] in [0, L),
    padding included."""
    e = emissions(params, word_windows, predicate, mark, lengths, impl=impl)
    ll = crf_ops.crf_log_likelihood(crf_ops.CRFParams(**params["crf"]), e,
                                    labels, lengths)
    return -torch.mean(ll)


def decode(params, word_windows, predicate, mark, lengths, *, impl=None):
    """Viterbi tag sequences [B, T] (past each length: the extended
    path, as `ops.crf.crf_decode`)."""
    e = emissions(params, word_windows, predicate, mark, lengths, impl=impl)
    tags, _ = crf_ops.crf_decode(crf_ops.CRFParams(**params["crf"]), e,
                                 lengths)
    return tags
