"""Per-row token sampling and the speculative verify rules (mirror of
the serving sampler in `paddle_tpu.ops.sampling`).

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
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from paddle_tpu_torch.core.dtypes import at_least_f32


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
