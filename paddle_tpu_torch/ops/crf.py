"""Linear-chain CRF: log-likelihood training and Viterbi decoding (port
of `paddle_tpu.ops.crf`).

Emission scores [B, T, N] come from the network; the transition
parameters are {start [N], end [N], trans [N, N]}, trans[i, j] the score
of i -> j. Variable lengths are handled by masking: past its length a
row's forward variables and Viterbi scores carry through unchanged.

The two dynamic programs (the forward algorithm for log Z and Viterbi)
are Python loops over the T-1 transitions of [B, N, N] torch ops, as the
JAX package's are `lax.scan`s of jnp ops: neither package has a kernel
for them. Gradients come from autograd. Ties in Viterbi go to the first
maximal index (`torch.argmax`, as `jnp.argmax`).

Tags handed to `crf_sequence_score` / `crf_log_likelihood` must lie in
[0, N) everywhere, padding included (pad with 0): the padded pairs are
gathered before they are masked out.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.nn import initializers


class CRFParams(NamedTuple):
    start: torch.Tensor  # [N]
    end: torch.Tensor    # [N]
    trans: torch.Tensor  # [N, N]  trans[i, j] = score(i -> j)


def init_crf_params(rng, num_tags: int, scale: float = 0.1, *,
                    device=None) -> CRFParams:
    """N(0, scale^2) start, end and trans. rng: an int seed, a numpy
    RandomState or a CPU torch.Generator (draws differ from
    `jax.random`'s). device None -> cuda (raises without one)."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    draw = initializers.normal(scale)
    return CRFParams(start=draw(rng, (num_tags,)).to(dev),
                     end=draw(rng, (num_tags,)).to(dev),
                     trans=draw(rng, (num_tags, num_tags)).to(dev))


def _mask(lengths, t, device):
    return torch.arange(t, device=device)[None, :] < \
        lengths.to(device)[:, None]


def crf_log_norm(params: CRFParams, emissions, lengths):
    """log Z per sequence by the forward algorithm. emissions [B, T, N],
    lengths [B]; returns [B]."""
    t = emissions.shape[1]
    mask = _mask(lengths, t, emissions.device)
    alpha = params.start[None, :] + emissions[:, 0]            # [B, N]
    for s in range(1, t):
        # alpha'[j] = logsumexp_i(alpha[i] + trans[i, j]) + emit[j]
        scores = alpha[:, :, None] + params.trans[None, :, :]
        new_alpha = torch.logsumexp(scores, dim=1) + emissions[:, s]
        alpha = torch.where(mask[:, s, None], new_alpha, alpha)
    return torch.logsumexp(alpha + params.end[None, :], dim=-1)


def crf_sequence_score(params: CRFParams, emissions, tags, lengths):
    """Score of the tag path `tags` [B, T] per sequence: [B]."""
    t = emissions.shape[1]
    tags = tags.long()
    lengths = lengths.to(emissions.device)
    mask = _mask(lengths, t, emissions.device).to(emissions.dtype)
    emit_scores = torch.gather(emissions, -1, tags[..., None])[..., 0]
    emit_total = torch.sum(emit_scores * mask, dim=1)
    trans_scores = params.trans[tags[:, :-1], tags[:, 1:]]     # [B, T-1]
    trans_total = torch.sum(trans_scores * mask[:, 1:], dim=1)
    start_total = params.start[tags[:, 0]]
    last_idx = torch.clamp(lengths.long() - 1, 0, t - 1)
    last_tags = torch.gather(tags, 1, last_idx[:, None])[:, 0]
    end_total = params.end[last_tags]
    return emit_total + trans_total + start_total + end_total


def crf_log_likelihood(params: CRFParams, emissions, tags, lengths):
    """Per-sequence log p(tags | emissions): [B] (its negative is the
    training loss)."""
    return crf_sequence_score(params, emissions, tags, lengths) - \
        crf_log_norm(params, emissions, lengths)


def crf_decode(params: CRFParams, emissions,
               lengths) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viterbi decode: (best_tags [B, T] int64, best_score [B]).
    Positions past each sequence's length hold the argmax-extended path
    (the backpointer is the identity there), as in the JAX package; the
    caller masks them."""
    b, t, n = emissions.shape
    dev = emissions.device
    mask = _mask(lengths, t, dev)
    ident = torch.arange(n, device=dev)[None, :].expand(b, n)
    delta = params.start[None, :] + emissions[:, 0]
    bps = []
    for s in range(1, t):
        scores = delta[:, :, None] + params.trans[None, :, :]   # [B, i, j]
        best_prev = torch.argmax(scores, dim=1)                 # first max
        new_delta = torch.amax(scores, dim=1) + emissions[:, s]
        m = mask[:, s, None]
        delta = torch.where(m, new_delta, delta)
        bps.append(torch.where(m, best_prev, ident))
    final = delta + params.end[None, :]
    tag = torch.argmax(final, dim=-1)                           # [B]
    best_score = torch.amax(final, dim=-1)
    tags = [tag]
    for bp in reversed(bps):            # bps[s - 1] maps tag[s] -> tag[s-1]
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        tags.append(tag)
    return torch.stack(tags[::-1], dim=1), best_score
