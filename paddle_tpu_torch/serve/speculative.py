"""Speculative draft proposal: prompt-lookup (n-gram) drafting.

The serving engine's speculative round needs k candidate next tokens
per slot, cheap enough to produce on the host between steps. The
n-gram/prompt-lookup family ("Accelerating LLM Inference with Staged
Speculative Decoding" / vLLM's ngram speculator) drafts by HISTORY
MATCHING: find the most recent earlier occurrence of the sequence's
current suffix n-gram and propose the tokens that followed it. On
repetitive traffic — code, structured extraction, templated replies,
anything where the model re-emits spans it has already seen — the
match rate (and so the verify acceptance rate) is high; on novel text
it degrades to draft_len-0 rounds, which the engine runs as plain
decode steps.

The proposer is DETERMINISTIC (a point-mass q), which is what makes
`ops.sampling.ngram_spec_verify`'s acceptance rule exact: accept draft
d with probability p(d) under the row's filtered target distribution,
redraw rejections from the residual. Greedy rows keep bit-exact parity
with the baseline: a deterministic proposal is either the argmax (kept)
or not (the round degenerates at that position).

Host-side only — pure numpy over python ints, no jax, safe under
`transfer_guard("disallow")` by construction (same discipline as
serve.policy)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class NGramProposer:
    """Prompt-lookup drafter: longest-suffix n-gram matching over the
    request's full token history (prompt + everything emitted).

    For n from `max_ngram` down to `min_ngram`, take the history's
    last n tokens and find their most recent earlier occurrence; on a
    match, propose the (up to) k tokens that followed it. The deepest
    n that matches wins — a longer matched context is a better
    predictor — and the most recent occurrence wins within an n (the
    nearest context is the likeliest continuation in templated
    traffic)."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Up to `k` draft tokens continuing `history` (possibly
        fewer — the match may sit near the history's end; possibly
        none — no suffix recurs). Never proposes from beyond the
        history it is handed."""
        h = np.asarray(history, dtype=np.int64)
        t = h.shape[0]
        if k < 1 or t < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, t - 1), self.min_ngram - 1,
                       -1):
            suffix = h[t - n:]
            # windows of width n over h[:-1] (candidate match starts
            # whose continuation exists), most recent first
            starts = np.arange(t - n)
            if starts.size == 0:
                continue
            windows = h[starts[:, None] + np.arange(n)[None, :]]
            hits = np.nonzero((windows == suffix[None, :]).all(
                axis=1))[0]
            if hits.size == 0:
                continue
            src = int(hits[-1]) + n          # continuation start
            return [int(x) for x in h[src:src + k]]
        return []

    def draft(self, history: Sequence[int], k: int) -> List[int]:
        """Up to `k` draft tokens, SELF-EXTENDING: when the matched
        continuation clips at the history's end — the loop case, where
        the suffix's most recent occurrence overlaps the end and
        `propose` can only hand back one period — re-match over
        history + the tokens already drafted. Still a deterministic
        function of `history` alone (a point-mass q), so the verify
        acceptance rule stays exact. This is what the serving engine
        calls; `propose` remains the one-shot primitive."""
        out: List[int] = []
        h = list(history)
        while len(out) < k:
            nxt = self.propose(h, k - len(out))
            if not nxt:
                break
            out.extend(nxt)
            h.extend(nxt)
        return out[:k]
