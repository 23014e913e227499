"""Per-row token sampling (mirror of the serving sampler in
`paddle_tpu.ops.sampling`).

`per_row_filter_logits` / `per_row_sample` are the
temperature/top-k/top-p convention the serving engine draws through.
Temperature 0 is the exact argmax degenerate (the greedy parity gate);
`torch.argmax` returns the first maximum, as `jnp.argmax` does.

Randomness: a categorical draw is the Gumbel-max trick,
`argmax(filtered + g)` with `g = -log(-log(u))`. The Gumbel noise is
injectable (`noise=`), so a test can hand the port the draws the JAX
side used; otherwise each row draws its noise from its own
`torch.Generator` (the engine's per-slot streams). Those streams do not
reproduce `jax.random`'s bits.
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
        if generators is None:
            noise = gumbel_noise((n, v), device=filtered.device)
        else:
            noise = torch.stack([
                gumbel_noise((v,), generator=g, device=filtered.device)
                for g in generators])
    draw = torch.argmax(filtered + noise.to(filtered.dtype), dim=-1)
    greedy = torch.argmax(at_least_f32(logits), dim=-1)
    return torch.where(temperature <= 0.0, greedy, draw)
