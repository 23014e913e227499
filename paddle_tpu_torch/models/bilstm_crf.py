"""BiLSTM-CRF sequence tagger (port of `paddle_tpu.models.bilstm_crf`):
embedding -> a forward and a reversed LSTM -> emissions -> linear-chain
CRF loss and Viterbi decoding, over dense padded token batches.

The two LSTMs are `RecurrentGroup`s over `lstm_group`'s step, as in the
JAX package, so this model runs no kernel: its time loops are torch ops
under autograd on every device.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.nn.recurrent_group import RecurrentGroup, lstm_group
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import rnn as rnn_ops


def init_params(rng, vocab_size: int, num_tags: int, *, embed_dim: int = 32,
                hidden: int = 64, device=None):
    """The JAX package's tree ({embed, fwd, bwd, proj, crf}) and
    distributions. rng: an int seed, a numpy RandomState or a CPU
    torch.Generator (draws differ from `jax.random`'s). device None ->
    cuda (raises without one)."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    params = {
        "embed": initializers.normal(0.05)(rng, (vocab_size, embed_dim)),
        "fwd": rnn_ops.init_lstm_params(rng, embed_dim, hidden),
        "bwd": rnn_ops.init_lstm_params(rng, embed_dim, hidden),
        "proj": {
            "kernel": initializers.smart_uniform()(rng,
                                                   (2 * hidden, num_tags)),
            "bias": torch.zeros(num_tags),
        },
        "crf": crf_ops.init_crf_params(rng, num_tags, device="cpu")._asdict(),
    }
    return tree_map(lambda t: t.to(dev), params)


def emissions(params, tokens, lengths):
    """[B, T, N] tag scores from two recurrent groups (forward and
    reversed) built from one LSTM step."""
    x = params["embed"][tokens.long()]
    hidden = params["fwd"]["w_hh"].shape[0]
    step, mems = lstm_group(x.shape[-1], hidden)
    fwd_out, _ = RecurrentGroup(step, mems).run(params["fwd"], x, lengths)
    bwd_out, _ = RecurrentGroup(step, mems, reverse=True).run(
        params["bwd"], x, lengths)
    h = torch.cat([fwd_out, bwd_out], dim=-1)
    return linalg.dense(h, params["proj"]["kernel"], params["proj"]["bias"])


def loss(params, tokens, tags, lengths):
    """Mean negative CRF log-likelihood."""
    e = emissions(params, tokens, lengths)
    ll = crf_ops.crf_log_likelihood(crf_ops.CRFParams(**params["crf"]), e,
                                    tags, lengths)
    return -torch.mean(ll)


def decode(params, tokens, lengths):
    """Viterbi (tags [B, T], scores [B])."""
    e = emissions(params, tokens, lengths)
    return crf_ops.crf_decode(crf_ops.CRFParams(**params["crf"]), e, lengths)
