"""N-gram word-embedding model (port of `paddle_tpu.models.word2vec`,
the word2vec book chapter): the context words share ONE embedding table
(a single gather), concat, an fc sigmoid hidden, then a softmax over the
vocabulary -- or NCE against log-uniform negatives from the same output
table. The output table stays [V, H] (JAX's layout) so NCE can gather
its rows.

`loss_nce` draws its negatives from a torch.Generator, or takes them
injected (`noise_ids=`): `jax.random` and torch never draw alike.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.ops import linalg, losses, sampling


def init_params(rng, vocab: int, *, embed_dim: int = 32, hidden: int = 256,
                context: int = 4, device=None):
    """{"embed" [V, E], "hidden": {kernel [context * E, H], bias},
    "out": {kernel [V, H], bias [V]}}. rng as in `traffic.init_params`;
    device None -> cuda."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    params = {
        "embed": initializers.normal(0.05)(rng, (vocab, embed_dim)),
        "hidden": {
            "kernel": initializers.smart_uniform()(
                rng, (context * embed_dim, hidden)),
            "bias": torch.zeros(hidden),
        },
        "out": {
            "kernel": initializers.smart_uniform()(rng, (vocab, hidden)),
            "bias": torch.zeros(vocab),
        },
    }
    return tree_map(lambda t: t.to(dev), params)


def features(params, context_ids):
    """context_ids [B, N-1] int -> hidden features [B, H]."""
    emb = params["embed"][context_ids.long()]               # [B, N-1, E]
    h = linalg.dense(emb.reshape(emb.shape[0], -1),
                     params["hidden"]["kernel"], params["hidden"]["bias"])
    return torch.sigmoid(h)


def logits(params, context_ids):
    """Full-softmax logits [B, V]."""
    h = features(params, context_ids)
    return h @ params["out"]["kernel"].T + params["out"]["bias"]


def loss(params, context_ids, next_ids):
    """Mean softmax cross-entropy against the next word."""
    return torch.mean(losses.softmax_cross_entropy(
        logits(params, context_ids), next_ids))


def loss_nce(params, context_ids, next_ids,
             generator: Optional[torch.Generator] = None, *,
             num_noise: int = 16, noise_ids: Optional[torch.Tensor] = None):
    """Mean NCE loss against num_noise log-uniform negatives a row
    (noise_ids [B, num_noise], injected, or drawn from `generator` on
    the features' device), with the log(k Q) correction of the
    log-uniform sampler's probabilities."""
    h = features(params, context_ids)
    vocab = params["out"]["kernel"].shape[0]
    if noise_ids is None:
        noise_ids = sampling.log_uniform_sample(
            generator, num_noise, vocab, shape=(context_ids.shape[0],),
            device=h.device)
    per_ex = sampling.nce_loss(
        params["out"]["kernel"], params["out"]["bias"], h, next_ids,
        noise_ids.to(h.device),
        noise_probs=sampling.log_uniform_prob(
            torch.arange(vocab, device=h.device), vocab))
    return torch.mean(per_ex)


def nearest(params, word_ids, k: int = 5):
    """The k nearest words [B, k] by embedding cosine (self at rank 0);
    ties keep the lower id first."""
    table = params["embed"]
    unit = lambda t: t / torch.clamp(
        torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-8)
    sims = unit(table[word_ids.long()]) @ unit(table).T
    return torch.sort(sims, dim=-1, descending=True, stable=True
                      ).indices[:, :k]
