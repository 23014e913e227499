"""Per-row token sampling, the speculative verify rules, and the
sampled and tree-structured output losses (port of
`paddle_tpu.ops.sampling`).

`per_row_filter_logits` / `per_row_sample` are the
temperature/top-k/top-p convention the serving engine draws through.
Temperature 0 is the exact argmax degenerate (the greedy parity gate);
`torch.argmax` returns the first maximum, as `jnp.argmax` does.

`greedy_spec_verify` / `ngram_spec_verify` score a speculative verify
window: a deterministic draft token d is accepted with probability p(d)
under the row's filtered target distribution (greedy rows: iff it is
the argmax), and a rejection redraws from the residual (p with d
removed). The emitted tokens are distributed as token-by-token sampling
from the target.

Randomness: a categorical draw is the Gumbel-max trick,
`argmax(filtered + g)` with `g = -log(-log(u))`. The Gumbel noise (and
the verify rule's acceptance uniforms) are injectable (`noise=`, `u=`),
so a test can hand the port the draws the JAX side used; otherwise each
row draws from its own `torch.Generator` (the engine's per-slot
streams). Those streams do not reproduce `jax.random`'s bits.

Losses for large vocabularies: noise-contrastive estimation (`nce_loss`)
with the log-uniform candidate sampler (`log_uniform_sample`, whose
uniforms are injectable as `u=`, `log_uniform_prob`), and the
hierarchical sigmoid over a complete binary tree
(`build_binary_tree_codes`, a numpy copy; `hsigmoid_loss`,
`hsigmoid_predict`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.dtypes import at_least_f32
from paddle_tpu_torch.ops.activations import softplus


def per_row_filter_logits(logits, temperature, top_k, top_p):
    """Temperature scaling, then top-k truncation, then nucleus
    filtering with PER-ROW parameters: logits [N, V]; temperature [N]
    (>0 -- the temp=0 greedy degenerate is per_row_sample's job), top_k
    [N] int (>= V means no truncation), top_p [N] (1.0 = no nucleus).
    Filtered-out tokens become -inf."""
    v = logits.shape[-1]
    x = at_least_f32(logits) / torch.clamp(
        temperature.to(torch.float32), min=1e-6)[:, None]
    desc = torch.sort(x, dim=-1, descending=True).values
    k_eff = torch.clamp(top_k.long(), 1, v)
    kth = torch.gather(desc, 1, (k_eff - 1)[:, None])
    neg_inf = float("-inf")
    x = x.masked_fill(x < kth, neg_inf)
    ar = torch.arange(v, device=x.device)[None, :]
    desc = desc.masked_fill(ar >= k_eff[:, None], neg_inf)
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    cutoff = desc.masked_fill(cum >= top_p.to(x.dtype)[:, None],
                              float("inf"))
    cutoff = cutoff.min(dim=-1, keepdim=True).values
    return x.masked_fill(x < cutoff, neg_inf)


def gumbel_noise(shape, *, generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def per_row_sample(logits, temperature, top_k, top_p, *,
                   noise: Optional[torch.Tensor] = None,
                   generators: Optional[Sequence[torch.Generator]] = None):
    """Per-row sampled next tokens [N]: rows with temperature 0 take
    argmax, the rest draw from their own filtered distribution.

    noise: [N, V] Gumbel draws (injected); else `generators`, one
    torch.Generator per row (each row's draw depends only on its own
    stream), or None for torch's default generator."""
    filtered = per_row_filter_logits(logits, temperature, top_k, top_p)
    if noise is None:
        n, v = filtered.shape
        noise = _row_draws(n, v, generators, filtered.device, gumbel=True)
    draw = torch.argmax(filtered + noise.to(filtered.dtype), dim=-1)
    greedy = torch.argmax(at_least_f32(logits), dim=-1)
    return torch.where(temperature <= 0.0, greedy, draw)


def _row_draws(n: int, size: int, generators, device, *, gumbel: bool):
    """[n, size] uniforms (Gumbel draws with gumbel=True), row i from
    generators[i] (torch's default generator when None)."""
    fn = gumbel_noise if gumbel else torch.rand
    if generators is None:
        return fn((n, size), device=device)
    return torch.stack([fn((size,), generator=g, device=device)
                        for g in generators])


def greedy_spec_verify(logits, window, draft_len):
    """The all-greedy verify rule: accept draft j iff it IS the argmax;
    the next token is the argmax at the break. logits [S, K+1, V];
    window [S, K+1] (column 0 the consumed carry token, 1..K the
    drafts); draft_len [S]. Returns (next_tok [S], n_acc [S], lp_draft
    [S, K] f32, lp_next [S] f32), log-probabilities under the full
    softmax."""
    s, k1, v = logits.shape
    k = k1 - 1
    raw = at_least_f32(logits)
    greedy = torch.argmax(raw, dim=-1)                     # [S, K+1]
    logp = torch.log_softmax(raw, dim=-1)
    rows = torch.arange(s, device=logits.device)
    if k > 0:
        drafts = window[:, 1:].long()
        ok = (drafts == greedy[:, :k]) & (
            torch.arange(k, device=logits.device)[None, :]
            < draft_len[:, None])
        n_acc = _first_false(ok)
        lp_draft = torch.gather(logp[:, :k], 2, drafts[:, :, None])[:, :, 0]
    else:
        n_acc = torch.zeros(s, dtype=torch.long, device=logits.device)
        lp_draft = torch.zeros((s, 0), dtype=torch.float32,
                               device=logits.device)
    next_tok = greedy[rows, n_acc]
    lp_next = logp[rows, n_acc, next_tok]
    return (next_tok, n_acc, lp_draft.to(torch.float32),
            lp_next.to(torch.float32))


def _first_false(ok):
    """Index of the first False in each row of ok [S, K] (K when every
    entry is True): the accepted draft count."""
    pad = torch.zeros((ok.shape[0], 1), dtype=torch.bool, device=ok.device)
    return torch.argmin(torch.cat([ok, pad], dim=1).to(torch.int32), dim=1)


def ngram_spec_verify(logits, window, draft_len, temperature, top_k, top_p,
                      *, u: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generators: Optional[Sequence[torch.Generator]] = None):
    """The speculative acceptance rule for deterministic drafts,
    vectorized over a slot pool. logits [S, K+1, V] (logits[s, i] is the
    distribution of the token FOLLOWING window[s, i]); window [S, K+1];
    draft_len [S] in [0, K]; temperature/top_k/top_p [S] the rows' own
    sampler (temperature 0 = greedy accept).

    u [S, K]: the acceptance uniforms; noise [S, V]: the Gumbel draws of
    the residual (or plain, after full acceptance) redraw at the break.
    Both default to draws from `generators`, one per row.

    Returns (next_tok [S], n_acc [S], lp_draft [S, K] f32, lp_next [S]
    f32): n_acc accepted drafts; next_tok target-sampled at the break;
    log-probabilities under the FULL softmax."""
    s, k1, v = logits.shape
    k = k1 - 1
    dev = logits.device
    drafts = window[:, 1:].long()                          # [S, K]
    raw = at_least_f32(logits)
    greedy = torch.argmax(raw, dim=-1)                     # [S, K+1]
    if u is None:
        u = _row_draws(s, k, generators, dev, gumbel=False)
    rep = lambda x: torch.repeat_interleave(x, k1)
    filt = per_row_filter_logits(
        raw.reshape(s * k1, v),
        rep(torch.clamp(temperature.to(torch.float32), min=1e-6)),
        rep(top_k), rep(top_p)).reshape(s, k1, v)
    logp_f = torch.log_softmax(filt, dim=-1)               # filtered
    logp = torch.log_softmax(raw, dim=-1)                  # full
    if k > 0:
        p_d = torch.gather(logp_f[:, :k], 2, drafts[:, :, None])[:, :, 0]
        sampled_ok = u < torch.exp(p_d)                    # q = delta_d
        greedy_ok = drafts == greedy[:, :k]
        ok = torch.where(temperature[:, None] <= 0.0, greedy_ok, sampled_ok)
        ok = ok & (torch.arange(k, device=dev)[None, :] < draft_len[:, None])
        n_acc = _first_false(ok)
    else:
        n_acc = torch.zeros(s, dtype=torch.long, device=dev)
    rows = torch.arange(s, device=dev)
    filt_b = filt[rows, n_acc]                             # [S, V]
    raw_b = raw[rows, n_acc]
    # rejection residual: p with the rejected draft removed; after FULL
    # acceptance there is no rejected token -- draw from p itself
    if k > 0:
        d_brk = drafts[rows, torch.clamp(n_acc, max=k - 1)]
    else:
        d_brk = torch.zeros(s, dtype=torch.long, device=dev)
    rejected = n_acc < draft_len
    resid = filt_b.masked_fill(
        rejected[:, None] & (torch.arange(v, device=dev)[None, :]
                             == d_brk[:, None]), float("-inf"))
    # degenerate residual (the filter kept ONLY the draft): p(d) = 1, a
    # rejection has measure zero; draw from p
    resid = torch.where(torch.isneginf(resid).all(dim=-1, keepdim=True),
                        filt_b, resid)
    if noise is None:
        noise = _row_draws(s, v, generators, dev, gumbel=True)
    draw = torch.argmax(resid + noise.to(resid.dtype), dim=-1)
    next_tok = torch.where(temperature <= 0.0, greedy[rows, n_acc], draw)
    if k > 0:
        lp_draft = torch.gather(logp[:, :k], 2, drafts[:, :, None])[:, :, 0]
    else:
        lp_draft = torch.zeros((s, 0), dtype=torch.float32, device=dev)
    lp_next = torch.gather(torch.log_softmax(raw_b, dim=-1), 1,
                           next_tok[:, None])[:, 0]
    return (next_tok, n_acc, lp_draft.to(torch.float32),
            lp_next.to(torch.float32))


# -- sampled and tree-structured output losses --------------------------------


def log_uniform_sample(generator: Optional[torch.Generator],
                       num_samples: int, vocab: int, shape=(), *,
                       u: Optional[torch.Tensor] = None, device=None):
    """Log-uniform (Zipf-like) negative ids, P(k) proportional to
    log((k+2)/(k+1)): int64 ids [*shape, num_samples], k = clip(int(exp(u
    * log(vocab + 1)) - 1), 0, vocab - 1). u: the uniforms (injected), or
    drawn in f32 from `generator` on `device` (or the generator's)."""
    if u is None:
        dev = device if device is not None else (
            generator.device if generator is not None else None)
        u = torch.rand((*shape, num_samples), generator=generator,
                       device=dev)
    ids = torch.exp(u * math.log(float(vocab + 1))) - 1.0
    return torch.clamp(ids.to(torch.int32), 0, vocab - 1).long()


def log_uniform_prob(ids, vocab: int):
    """The sampler's probability of each id (f32)."""
    k = ids.to(torch.float32)
    return torch.log((k + 2.0) / (k + 1.0)) / math.log(float(vocab + 1))


def nce_loss(weights, bias, hidden, labels, noise_ids, *, noise_probs=None,
             true_probs=None):
    """Noise-contrastive estimation, per example [B]: softplus(-s+) +
    sum softplus(s-) over the true class's and the S noise ids' logits
    (weights [V, D], bias [V], hidden [B, D], labels [B], noise_ids
    [B, S]). noise_probs: the sampler's probabilities for the log(k Q)
    correction, either [V] per class (the true class's looked up) or
    [B, S] per sample, which then needs true_probs [B]; None: plain
    binary logistic (uniform noise)."""
    labels = labels.long()
    noise_ids = noise_ids.long()
    true_logit = (weights[labels] * hidden).sum(-1) + bias[labels]
    noise_logit = torch.einsum("bsd,bd->bs", weights[noise_ids], hidden) \
        + bias[noise_ids]
    if noise_probs is not None:
        k = noise_ids.shape[-1]
        q = torch.as_tensor(noise_probs, device=hidden.device)
        if q.ndim == 1:
            true_q, nq = q[labels], q[noise_ids]
        else:
            if true_probs is None:
                raise ValueError(
                    "noise_probs is per-sample [B, S]; pass true_probs [B] "
                    "so the log(k*Q) correction applies to the true class "
                    "too (omitting it biases the NCE objective)")
            true_q = torch.as_tensor(true_probs, device=hidden.device)
            nq = q
        true_logit = true_logit - torch.log(k * true_q + 1e-20)
        noise_logit = noise_logit - torch.log(k * nq + 1e-20)
    return softplus(-true_logit) + softplus(noise_logit).sum(-1)


def build_binary_tree_codes(num_classes: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Complete-binary-tree paths for the hierarchical sigmoid: (node_ids
    [V, depth] int32 with -1 padding, signs [V, depth] f32, +1 for a left
    child). Internal node i has children 2i+1 and 2i+2; the classes are
    the leaves after the num_classes - 1 internal nodes."""
    num_internal = num_classes - 1
    depth = max(int(np.ceil(np.log2(max(num_classes, 2)))), 1)
    node_ids = np.full((num_classes, depth), -1, np.int32)
    signs = np.zeros((num_classes, depth), np.float32)
    for c in range(num_classes):
        path = []
        node = num_internal + c
        while node > 0:
            parent = (node - 1) // 2
            is_left = node == 2 * parent + 1
            path.append((parent, 1.0 if is_left else -1.0))
            node = parent
        path.reverse()
        for d, (nid, sign) in enumerate(path):
            node_ids[c, d] = nid
            signs[c, d] = sign
    return node_ids, signs


def _tree_codes(node_ids, signs, device):
    ids = torch.as_tensor(node_ids, device=device).long()
    return ids, torch.as_tensor(signs, device=device)


def hsigmoid_loss(node_weights, node_bias, hidden, labels, node_ids, signs):
    """Hierarchical-sigmoid loss per example [B]: the sum of
    -log sigmoid(sign * logit) over the label's path (node_weights
    [num_internal, D], node_bias [num_internal], hidden [B, D], labels
    [B], node_ids/signs [V, depth] from build_binary_tree_codes)."""
    ids, sgn = _tree_codes(node_ids, signs, hidden.device)
    labels = labels.long()
    ids, sgn = ids[labels], sgn[labels]                       # [B, depth]
    safe = torch.clamp(ids, min=0)
    logits = torch.einsum("bkd,bd->bk", node_weights[safe], hidden) \
        + node_bias[safe]
    losses = softplus(-sgn * logits)
    return torch.where(ids >= 0, losses, 0.0).sum(-1)


def hsigmoid_predict(node_weights, node_bias, hidden, node_ids, signs):
    """log P(class) under the tree for every class: [B, V]."""
    ids, sgn = _tree_codes(node_ids, signs, hidden.device)
    safe = torch.clamp(ids, min=0)
    logits = torch.einsum("vkd,bd->bvk", node_weights[safe], hidden) \
        + node_bias[safe][None]
    logp = -softplus(-sgn[None] * logits)
    return torch.where((ids >= 0)[None], logp, 0.0).sum(-1)
