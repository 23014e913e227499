"""Sequence ops over packed ragged batches and dense padded batches
(port of `paddle_tpu.ops.sequence`).

Packed layout, for the segment ops:
  tokens      [capacity, ...]  packed values
  segment_ids [capacity]       int sequence index; ids outside
                               [0, num_segments) mark padding slots
  num_segments: int -- max sequences per batch (lengths may be 0)

The JAX `jax.ops.segment_*` reductions become `index_add` and
`scatter_reduce` into num_segments + 1 rows, the last catching padding
(JAX drops out-of-range ids; torch would raise on them). An empty
segment's max is -inf, zeroed where the JAX package zeroes it.

Dense layout: [B, T, ...] with lengths [B] (`length_mask`,
`dense_sequence_pool`, `context_projection`, `sequence_conv`,
`kmax_seq_score`). Nested (2-level) sequences carry inner segment ids
per position plus a [num_inner] map `outer_of_inner`.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops import linalg

NEG_INF = -1e30


def length_mask(lengths, max_len: int):
    """[B, T] boolean mask from lengths."""
    return torch.arange(max_len, device=lengths.device)[None, :] < \
        lengths[:, None]


def dense_sequence_pool(x, lengths, mode: str = "mean"):
    """Pool a padded dense [B, T, F] batch per sequence. "max" reduces
    with `torch.amax`, which splits a tie's gradient evenly among the
    tied entries, as `jnp.max` does."""
    t = x.shape[1]
    mask = length_mask(lengths, t)
    maskf = mask.to(x.dtype)[..., None]
    if mode == "sum":
        return torch.sum(x * maskf, dim=1)
    if mode == "mean":
        denom = torch.clamp(lengths.to(x.dtype), min=1)[:, None]
        return torch.sum(x * maskf, dim=1) / denom
    if mode == "sqrt":
        denom = torch.sqrt(torch.clamp(lengths.to(x.dtype), min=1))[:, None]
        return torch.sum(x * maskf, dim=1) / denom
    if mode == "max":
        neg = torch.where(mask[..., None], x, NEG_INF)
        out = torch.amax(neg, dim=1)
        return torch.where(out <= NEG_INF / 2, 0.0, out)
    nonempty = (lengths > 0).to(x.dtype)[:, None]
    if mode == "last":
        idx = torch.clamp(lengths.long() - 1, 0, t - 1)
        return torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0] * \
            nonempty
    if mode == "first":
        # zero-length rows return 0, consistent with sum/mean/max
        return x[:, 0] * nonempty
    raise ValueError(f"unknown pool mode {mode!r}")


# ---- packed segment ops --------------------------------------------------


def _bcast(v, like):
    """v [N] viewed as [N, 1, ...] against `like` [N, ...]."""
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def _sentinel_ids(segment_ids, num_segments: int):
    """int64 ids with every id outside [0, num_segments) sent to the
    sentinel row num_segments."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def _segment_sum(data, segment_ids, num_segments: int):
    """`jax.ops.segment_sum(data, ids, num_segments)`: out-of-range ids
    are dropped."""
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, _sentinel_ids(segment_ids, num_segments),
                         data)[:num_segments]


def _segment_reduce(data, segment_ids, num_segments: int, reduce: str,
                    empty):
    """`jax.ops.segment_max` ("amax") / `segment_min` ("amin"): an empty
    segment holds `empty` (JAX's -inf, or the dtype's max for a min)."""
    ids = _sentinel_ids(segment_ids, num_segments)
    idx = ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand(data.shape)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), empty,
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, idx, data, reduce,
                              include_self=False)[:num_segments]


def _segment_max(data, segment_ids, num_segments: int):
    return _segment_reduce(data, segment_ids, num_segments, "amax",
                           float("-inf"))


def _segment_min_int(data, segment_ids, num_segments: int):
    return _segment_reduce(data, segment_ids, num_segments, "amin",
                           torch.iinfo(data.dtype).max)


def _valid_mask(segment_ids, num_segments):
    return segment_ids < num_segments


def _counts(tokens, segment_ids, num_segments: int):
    ones = torch.ones(tokens.shape[:1], dtype=tokens.dtype,
                      device=tokens.device)
    return _segment_sum(ones, segment_ids, num_segments)


def sequence_sum(tokens, segment_ids, num_segments: int):
    """Per-sequence sum."""
    return _segment_sum(tokens, segment_ids, num_segments)


def sequence_mean(tokens, segment_ids, num_segments: int):
    """Per-sequence average (an empty sequence gives 0)."""
    sums = sequence_sum(tokens, segment_ids, num_segments)
    counts = torch.clamp(_counts(tokens, segment_ids, num_segments), min=1.0)
    return sums / _bcast(counts, sums)


def sequence_sqrt_pool(tokens, segment_ids, num_segments: int):
    """Sum scaled by 1/sqrt(len)."""
    sums = sequence_sum(tokens, segment_ids, num_segments)
    counts = torch.clamp(_counts(tokens, segment_ids, num_segments), min=1.0)
    return sums * _bcast(torch.rsqrt(counts), sums)


def sequence_max(tokens, segment_ids, num_segments: int):
    """Per-sequence max; an empty sequence gives 0 (JAX's segment_max
    gives -inf there, which the JAX package zeroes)."""
    out = _segment_max(tokens, segment_ids, num_segments)
    return torch.where(torch.isfinite(out), out, 0.0).to(out.dtype)


def sequence_first(tokens, segment_ids, positions, num_segments: int):
    """First timestep of each sequence."""
    cap = tokens.shape[0]
    is_first = (positions == 0) & _valid_mask(segment_ids, num_segments)
    idx = torch.where(is_first, segment_ids.long(), num_segments)
    rows = _segment_sum(
        torch.where(is_first[:, None], tokens.reshape(cap, -1), 0.0).to(
            tokens.dtype), idx, num_segments)
    return rows.reshape((num_segments,) + tuple(tokens.shape[1:]))


def sequence_last(tokens, segment_ids, positions, lengths, num_segments: int):
    """Last timestep of each sequence."""
    cap = tokens.shape[0]
    valid = _valid_mask(segment_ids, num_segments)
    seq_len = torch.where(
        valid, lengths[torch.clamp(segment_ids.long(), 0, num_segments - 1)],
        -1)
    is_last = valid & (positions == seq_len - 1)
    idx = torch.where(is_last, segment_ids.long(), num_segments)
    rows = _segment_sum(
        torch.where(is_last[:, None], tokens.reshape(cap, -1), 0.0).to(
            tokens.dtype), idx, num_segments)
    return rows.reshape((num_segments,) + tuple(tokens.shape[1:]))


def sequence_softmax(scores, segment_ids, num_segments: int):
    """Softmax within each sequence; scores [capacity]."""
    valid = _valid_mask(segment_ids, num_segments)
    safe_ids = torch.where(valid, segment_ids.long(), num_segments)
    masked = torch.where(valid, scores, NEG_INF)
    seg_max = _segment_max(masked, safe_ids, num_segments + 1)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    shifted = torch.where(valid, masked - seg_max[safe_ids], NEG_INF)
    exp = torch.where(valid, torch.exp(shifted), 0.0)
    denom = torch.clamp(_segment_sum(exp, safe_ids, num_segments + 1),
                        min=1e-12)
    return exp / denom[safe_ids]


def sequence_expand(seq_values, segment_ids, num_segments: int):
    """Broadcast one row per sequence to every position of it:
    [num_segments, ...] -> [capacity, ...] (padding slots 0)."""
    safe = torch.clamp(segment_ids.long(), 0, num_segments - 1)
    out = seq_values[safe]
    valid = _valid_mask(segment_ids, num_segments)
    return torch.where(_bcast(valid, out), out, 0.0).to(seq_values.dtype)


def masked_positions(tokens, mask, fill=0.0):
    """Set padding slots to `fill`."""
    return torch.where(_bcast(mask, tokens), tokens, fill)


def pack_to_dense(tokens, segment_ids, positions, num_segments: int,
                  max_len: int):
    """Packed [capacity, ...] -> (dense [num_segments, max_len, ...],
    mask [num_segments, max_len] bool)."""
    valid = _valid_mask(segment_ids, num_segments) & (positions < max_len)
    cells = num_segments * max_len
    flat_idx = torch.where(valid, segment_ids.long() * max_len +
                           positions.long(), cells)
    feat = tokens.reshape(tokens.shape[0], -1)
    dense = _segment_sum(torch.where(valid[:, None], feat, 0.0).to(
        feat.dtype), flat_idx, cells)
    dense = dense.reshape((num_segments, max_len) + tuple(tokens.shape[1:]))
    mask = _segment_sum(valid.to(torch.int32), flat_idx, cells)
    return dense, mask.reshape(num_segments, max_len) > 0


def dense_to_pack(dense, segment_ids, positions, num_segments: int):
    """Dense [num_segments, T, ...] -> packed [capacity, ...] at (seg,
    pos); padding slots 0."""
    t = dense.shape[1]
    valid = _valid_mask(segment_ids, num_segments) & (positions < t)
    safe_seg = torch.clamp(segment_ids.long(), 0, num_segments - 1)
    safe_pos = torch.clamp(positions.long(), 0, t - 1)
    out = dense[safe_seg, safe_pos]
    return torch.where(_bcast(valid, out), out, 0.0).to(dense.dtype)


# ---- nested (2-level) sequences ------------------------------------------


def outer_of_inner_map(segment_ids, outer_segment_ids, num_inner: int):
    """The [num_inner] inner -> outer map from per-position ids; unused
    inner slots map to the sentinel max(outer ids) + 1."""
    sentinel = torch.max(outer_segment_ids) + 1
    first = _segment_min_int(outer_segment_ids, segment_ids, num_inner + 1)
    counts = _segment_sum(torch.ones_like(segment_ids), segment_ids,
                          num_inner + 1)
    return torch.where(counts[:num_inner] > 0, first[:num_inner],
                       sentinel).to(torch.int32)


def nested_pool(tokens, segment_ids, outer_of_inner, num_inner: int,
                num_outer: int, *, inner_mode: str = "mean",
                outer_mode: str = "mean"):
    """Two-level pooling: positions -> sub-sequence -> outer sequence.
    Returns [num_outer, ...]; an empty outer sequence's "max" is -inf,
    as in the JAX package."""
    inner = {"sum": sequence_sum, "mean": sequence_mean,
             "max": sequence_max, "sqrt": sequence_sqrt_pool}[inner_mode](
        tokens, segment_ids, num_inner)
    if outer_mode == "sum":
        return _segment_sum(inner, outer_of_inner, num_outer)
    if outer_mode == "mean":
        s = _segment_sum(inner, outer_of_inner, num_outer)
        n = _segment_sum(torch.ones(outer_of_inner.shape, device=s.device),
                         outer_of_inner, num_outer)
        return s / _bcast(torch.clamp(n, min=1.0), s)
    if outer_mode == "max":
        return _segment_max(torch.where(torch.isfinite(inner), inner,
                                        NEG_INF).to(inner.dtype),
                            outer_of_inner, num_outer)
    raise ValueError(f"unknown outer_mode {outer_mode!r}")


def expand_outer_to_inner(outer_values, outer_of_inner):
    """Per-outer values to each of its sub-sequences: [num_outer, ...] ->
    [num_inner, ...] (0 for unused inner slots)."""
    safe = torch.clamp(outer_of_inner.long(), 0, outer_values.shape[0] - 1)
    valid = outer_of_inner < outer_values.shape[0]
    out = outer_values[safe]
    return torch.where(_bcast(valid, out), out, 0.0).to(out.dtype)


def first_subseq_of_outer(inner_values, outer_of_inner, num_outer: int):
    """Each outer sequence's first sub-sequence value: [num_inner, ...]
    -> [num_outer, ...] (0 for an outer sequence with none)."""
    num_inner = inner_values.shape[0]
    idx = torch.arange(num_inner, device=inner_values.device)
    first_idx = _segment_min_int(idx, outer_of_inner, num_outer)
    safe = torch.clamp(first_idx, 0, num_inner - 1)
    valid = first_idx < num_inner
    out = inner_values[safe]
    return torch.where(_bcast(valid, out), out, 0.0).to(out.dtype)


# ---- dense context windows -----------------------------------------------


def context_projection(x, lengths, *, context_len: int,
                       context_start: int = None, padding_weights=None):
    """Sliding context-window concat over a dense [B, T, F] batch: output
    position t concatenates the features at t + context_start .. t +
    context_start + context_len - 1; positions outside the sequence are
    zero or, with `padding_weights` [start_pad + end_pad, F], the
    trainable padding rows (row i of the start block for the i+1-th
    position before the sequence, row start_pad + j for the j+1-th past
    its end). Rows past each sequence's length are zero. lengths [B] or
    None (full). Returns [B, T, context_len * F]."""
    b, t, _ = x.shape
    dev = x.device
    if context_start is None:
        context_start = -(context_len // 2)  # the reference's default
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int64, device=dev)
    lens = lengths.to(dev).long()[:, None]
    start_pad = max(0, -context_start)
    end_pad = max(0, context_len + context_start - 1)
    pos = torch.arange(t, device=dev)
    pieces = []
    for j in range(context_len):
        src = (pos + context_start + j)[None, :].expand(b, t)
        valid = (src >= 0) & (src < lens)
        piece = x[:, torch.clamp(pos + context_start + j, 0, t - 1)]
        piece = torch.where(valid[..., None], piece, 0.0).to(x.dtype)
        if padding_weights is not None:
            if start_pad:
                # -src - 1 counts back from the sequence's first position
                row = torch.clamp(-src - 1, 0, start_pad - 1)
                piece = torch.where((src < 0)[..., None],
                                    padding_weights[:start_pad][row], piece)
            if end_pad:
                row = torch.clamp(src - lens, 0, end_pad - 1)
                piece = torch.where(
                    (src >= lens)[..., None],
                    padding_weights[start_pad:start_pad + end_pad][row],
                    piece)
        pieces.append(piece)
    out = torch.cat(pieces, dim=-1)
    # zero the rows past each sequence's end (not real positions)
    return out * (pos[None, :] < lens)[..., None].to(out.dtype)


def sequence_conv(x, lengths, filt, *, context_len: int,
                  context_start: int = None, bias=None,
                  padding_weights=None):
    """1-D sequence convolution: context projection, then x @ filt (+
    bias). filt [context_len * F, out]; returns [B, T, out]."""
    ctx = context_projection(x, lengths, context_len=context_len,
                             context_start=context_start,
                             padding_weights=padding_weights)
    return linalg.dense(ctx, filt, bias)


def kmax_seq_score(scores, lengths, k: int):
    """The k best score positions per padded sequence: int64 [B, k],
    descending by score, ties to the lower position (a stable sort, as
    `lax.top_k`). Padding never wins; where a sequence has fewer than k
    positions the rest repeat its best one."""
    t = scores.shape[1]
    dev = scores.device
    lens = lengths.to(dev).long()[:, None]
    valid = torch.arange(t, device=dev)[None, :] < lens
    masked = torch.where(valid, scores, float("-inf"))
    ids = torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :k]
    have = torch.clamp(lens, max=k)
    return torch.where(torch.arange(k, device=dev)[None, :] < have, ids,
                       ids[:, :1])
