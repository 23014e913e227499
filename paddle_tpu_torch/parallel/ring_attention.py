"""Long-context attention parallelism: ring attention and Ulysses
all-to-all (port of `paddle_tpu.parallel.ring_attention`).

The time dimension is sharded over the mesh `seq` axis and attention is
exact:

  * ring attention -- K/V shards travel around the `seq` ring by
    point-to-point sends (`collectives.ppermute_ring`, a
    `batch_isend_irecv`) while each rank keeps its Q shard; a streaming
    (flash-style) softmax merges the partials of each block, so no rank
    holds the full [T, T] scores or the full K/V.
  * Ulysses -- an all-to-all re-shards [T/n, H] to [T, H/n], each rank
    runs full-sequence attention over its heads, and a second
    all-to-all shards back; needs H % n == 0.

Both are differentiable: the sends' backward is the opposite shift and
the all-to-all's the inverse exchange. Scores, exp-sums and the running
partials are kept in f32 or wider whatever the compute dtype, as JAX
keeps them. `ring_attention` and `ulysses_attention` are per-rank code
(JAX: inside shard_map) over rank-local [B, T_local, H, D] blocks;
`make_sequence_parallel_attention` builds the whole-array function.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.core.mesh import SEQ_AXIS, Mesh
from paddle_tpu_torch.parallel import collectives as C

NEG_INF = -1e30


def _acc_dtype(dtype):
    return torch.promote_types(torch.float32, dtype)


def dense_attention(q, k, v, *, causal: bool = False, mask=None):
    """Reference dense attention. q,k,v: [B, T, H, D] -> [B, T, H, D].

    `mask`: optional [B, Tq, Tk] boolean, True = attend. Scores and
    softmax run in f32 whatever the compute dtype."""
    d = q.shape[-1]
    acc = _acc_dtype(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) \
        / torch.sqrt(torch.tensor(d, dtype=acc, device=q.device))
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        cm = (torch.arange(tq, device=q.device)[:, None]
              >= torch.arange(tk, device=q.device)[None, :])
        scores = torch.where(cm[None, None], scores, NEG_INF)
    if mask is not None:
        scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).to(acc),
                        v.to(acc)).to(q.dtype)


def _block_attend(q, k, v, q_offset: int, k_offset: int, *, causal: bool,
                  scale):
    """Partial attention of a Q block against one K/V block: (o, l, m),
    the un-normalised output [B,Tq,H,D], row sum l and row max m
    [B,Tq,H] (the streaming-softmax statistics), all in >= f32."""
    acc = _acc_dtype(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) \
        * scale.to(acc)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qpos = q_offset + torch.arange(tq, device=q.device)
        kpos = k_offset + torch.arange(tk, device=q.device)
        cm = qpos[:, None] >= kpos[None, :]
        scores = torch.where(cm[None, None], scores, NEG_INF)
    m = torch.amax(scores, dim=-1)                      # [B,H,Tq]
    p = torch.exp(scores - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc), v.to(acc))
    return o, l.transpose(1, 2), m.transpose(1, 2)


def _merge(acc, blk):
    """Merge streaming-softmax partials (o, l, m) of two blocks."""
    o1, l1, m1 = acc
    o2, l2, m2 = blk
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    o = o1 * a1[..., None] + o2 * a2[..., None]
    l = l1 * a1 + l2 * a2
    return o, l, m


def ring_attention(q, k, v, *, axis: str = SEQ_AXIS, causal: bool = False,
                   mesh: Optional[Mesh] = None):
    """Exact attention with the sequence sharded over the `axis` ring.

    Per-rank code: q,k,v are this rank's [B, T_local, H, D] blocks (the
    global sequence is their concatenation in axis-index order). K/V
    blocks go once around the ring (n - 1 shifts); a streaming softmax
    merges the block partials, so peak memory is O(T_local^2) scores."""
    m = C._mesh(mesh)
    n = m.shape[axis]
    idx = m.axis_index(axis)
    b, t_local, h, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype)
    acc_t = _acc_dtype(q.dtype)
    acc = (torch.zeros((b, t_local, h, d), dtype=acc_t, device=q.device),
           torch.zeros((b, t_local, h), dtype=acc_t, device=q.device),
           torch.full((b, t_local, h), NEG_INF, dtype=acc_t,
                      device=q.device))
    kb, vb, src = k, v, idx
    for s in range(n):
        blk = _block_attend(q, kb, vb, idx * t_local, src * t_local,
                            causal=causal, scale=scale)
        acc = _merge(acc, blk)
        if s < n - 1:
            # shard j -> shard j+1: after s shifts this rank holds the
            # block of rank idx - s
            kb = C.ppermute_ring(kb, axis, shift=1, mesh=m)
            vb = C.ppermute_ring(vb, axis, shift=1, mesh=m)
            src = (src - 1) % n
    o, l, _ = acc
    return (o / l[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, *, axis: str = SEQ_AXIS,
                      causal: bool = False, mesh: Optional[Mesh] = None):
    """Ulysses attention: all-to-all from sequence shards to head
    shards. Per-rank [B, T_local, H, D] blocks; needs H % axis size ==
    0. Each rank sees the FULL sequence for H/n heads, runs dense
    attention, and all-to-alls back to sequence shards."""
    m = C._mesh(mesh)
    qh, kh, vh = (C.all_to_all(t, axis, split_axis=2, concat_axis=1, mesh=m)
                  for t in (q, k, v))
    oh = dense_attention(qh, kh, vh, causal=causal)
    return C.all_to_all(oh, axis, split_axis=1, concat_axis=2, mesh=m)


def make_sequence_parallel_attention(
    mesh: Mesh,
    *,
    kind: str = "ring",
    causal: bool = False,
    batch_axis: Optional[str] = None,
    axis: str = SEQ_AXIS,
):
    """The whole-array attention fn(q, k, v) sharded over `axis`: takes
    global [B, T, H, D] arrays (DTensors, or plain tensors holding the
    full value on every rank), shards T over the seq axis (and B over
    `batch_axis`), runs the per-rank attention, and returns a DTensor
    placed so."""
    if kind == "ring":
        inner = ring_attention
    elif kind == "ulysses":
        inner = ulysses_attention
    else:
        raise ValueError(f"unknown kind {kind!r}: expected 'ring' or 'ulysses'")
    spec = (batch_axis, axis, None, None)

    def fn(q, k, v):
        local = [C.shard_local(t, spec, mesh=mesh) for t in (q, k, v)]
        o = inner(*local, axis=axis, causal=causal, mesh=mesh)
        return C.from_local(o, spec, q.shape, mesh=mesh)

    return fn
