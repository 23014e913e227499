"""Beam search and greedy decoding in fixed shapes (port of `NEG_INF`,
`BeamState`, `beam_search` and `greedy_search` of
`paddle_tpu.ops.beam_search`).

Every step scores B*K*V candidates, takes the top K (`torch.topk` over
[B, K*V]), tracks back-pointers, and finished beams absorb EOS with zero
added score. The loop runs on the host and stops as soon as every beam
has finished (the JAX `lax.while_loop`'s condition, read once per step):
running on to `max_len` would re-sort finished beams through top-k, where
ties may order differently. The final sort is stable, as `jnp.argsort`
is; `greedy_search` takes the first maximum, as `jnp.argmax` does.

The decoder state is any tree of nested dicts, lists and tuples of
tensors (`core.pytree`; tuples come back as lists), with leaves [B*K,
...] once tiled.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from paddle_tpu_torch.core.pytree import tree_leaves, tree_map

NEG_INF = -1e30


class BeamState(NamedTuple):
    """Loop carry: [B, K] beams."""

    tokens: torch.Tensor       # [B, K, L] emitted tokens (pad after finish)
    scores: torch.Tensor       # [B, K] cumulative log prob
    finished: torch.Tensor     # [B, K] bool
    decoder_state: Any         # model recurrent state, leaves [B*K, ...]
    step: int


def _device_of(tree, default=None):
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    if leaves:
        return leaves[0].device
    if default is None:
        raise ValueError("cannot tell the device: the decoder state holds "
                         "no tensor")
    return default


def beam_search(
    init_decoder_state,
    step_fn: Callable,
    *,
    batch_size: int,
    beam_size: int,
    max_len: int,
    bos_id: int,
    eos_id: int,
    vocab_size: int,
    length_penalty: float = 0.0,
    modify_logits_fn: Optional[Callable] = None,
    bos_tokens=None,
):
    """Run beam search.

    step_fn(tokens_t [B*K], decoder_state) -> (logits [B*K, V], new_state)
    where decoder_state leaves are [B*K, ...].
    init_decoder_state leaves must be [B, ...]; they are tiled to beams.
    modify_logits_fn(step, logits, state) -> logits, with step a Python
    int and state the BeamState before the step.
    bos_tokens: optional [B] per-row first input tokens; default: bos_id
    everywhere.

    Returns (tokens [B, K, max_len] int32, scores [B, K] f32, lengths
    [B, K] int32) sorted best-first per batch row.
    """
    b, k, v = batch_size, beam_size, vocab_size
    dev = _device_of(init_decoder_state,
                     None if bos_tokens is None else bos_tokens.device)
    i32 = torch.int32

    def tile_to_beams(x):
        return x.repeat_interleave(k, dim=0)

    live0 = torch.where(torch.arange(k, device=dev) == 0, 0.0, NEG_INF)
    state = BeamState(
        tokens=torch.full((b, k, max_len), eos_id, dtype=i32, device=dev),
        # only beam 0 is live at step 0 so identical first expansions
        # don't fill the beam with duplicates
        scores=live0.to(torch.float32)[None, :].repeat(b, 1),
        finished=torch.zeros((b, k), dtype=torch.bool, device=dev),
        decoder_state=tree_map(tile_to_beams, init_decoder_state),
        step=0,
    )
    if bos_tokens is None:
        prev_tokens = torch.full((b * k,), bos_id, dtype=i32, device=dev)
    else:
        prev_tokens = torch.as_tensor(bos_tokens, dtype=i32,
                                      device=dev).repeat_interleave(k)
    eos_only = torch.full((v,), NEG_INF, dtype=torch.float32, device=dev)
    eos_only[eos_id] = 0.0
    rows = torch.arange(b, device=dev)[:, None]

    while state.step < max_len and not bool(state.finished.all()):
        logits, new_dec = step_fn(prev_tokens, state.decoder_state)
        if modify_logits_fn is not None:
            logits = modify_logits_fn(state.step, logits, state)
        log_p = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        # finished beams: only EOS continuation, with zero added score
        log_p = torch.where(state.finished[:, :, None], eos_only, log_p)
        flat = (state.scores[:, :, None] + log_p).reshape(b, k * v)
        top_scores, top_idx = torch.topk(flat, k, dim=-1)      # [B, K]
        src_beam = top_idx // v
        new_token = (top_idx % v).to(i32)
        # gather histories and states from the source beams
        finished_src = state.finished[rows, src_beam]
        tokens = state.tokens[rows, src_beam]
        tokens[:, :, state.step] = torch.where(finished_src, eos_id,
                                               new_token)

        def gather_state(x):     # [B*K, ...] -> regrouped by src_beam
            xk = x.reshape((b, k) + tuple(x.shape[1:]))
            return xk[rows, src_beam].reshape(x.shape)

        state = BeamState(tokens=tokens, scores=top_scores,
                          finished=finished_src | (new_token == eos_id),
                          decoder_state=tree_map(gather_state, new_dec),
                          step=state.step + 1)
        prev_tokens = new_token.reshape(b * k)

    lengths = torch.sum(state.tokens != eos_id, dim=-1, dtype=i32)
    # include the terminating EOS in length when the beam finished
    lengths = torch.clamp(lengths + state.finished.to(i32), max=max_len)
    scores = state.scores
    if length_penalty > 0.0:
        denom = torch.pow(torch.clamp(lengths, min=1).float(),
                          length_penalty)
        scores = scores / denom
    order = torch.argsort(-scores, dim=-1, stable=True)
    return (state.tokens[rows, order], scores[rows, order],
            lengths[rows, order])


def greedy_search(
    init_decoder_state,
    step_fn: Callable,
    *,
    batch_size: int,
    max_len: int,
    bos_id: int,
    eos_id: int,
):
    """Greedy decode (the reference's oneWaySearch). Returns (tokens
    [B, max_len] int32, lengths [B] int32)."""
    dev = _device_of(init_decoder_state)
    i32 = torch.int32
    prev = torch.full((batch_size,), bos_id, dtype=i32, device=dev)
    state = init_decoder_state
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=dev)
    tokens = torch.full((batch_size, max_len), eos_id, dtype=i32, device=dev)
    t = 0
    while t < max_len and not bool(finished.all()):
        logits, state = step_fn(prev, state)
        nxt = torch.argmax(logits, dim=-1).to(i32)
        nxt = torch.where(finished, eos_id, nxt)
        finished = finished | (nxt == eos_id)
        tokens[:, t] = nxt
        prev = nxt
        t += 1
    lengths = torch.sum(tokens != eos_id, dim=-1, dtype=i32)
    any_eos = torch.any(tokens == eos_id, dim=-1)
    lengths = torch.clamp(lengths + any_eos.to(i32), max=max_len)
    return tokens, lengths
