"""Embedding lookups (port of `paddle_tpu.ops.embedding`): dense,
segment-combined bags, and the row-sharded table's placement.

The JAX module's functions, op for op. `shard_table_rows` places a table
row-sharded over the mesh `model` axis (`parallel.sparse.shard_rows`);
the sharded lookups themselves live in `parallel.sparse`.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.mesh import MODEL_AXIS


def embedding_lookup(table, ids):
    """Dense lookup [V, D] x [...] -> [..., D] (reference:
    operators/lookup_table_op.cc)."""
    return table[ids.long()]


def _segment_sum(x, segment_ids, num_segments: int):
    """jax.ops.segment_sum: rows of x summed into their segment; ids
    outside [0, num_segments) are dropped."""
    seg = segment_ids.long().reshape(-1)
    ok = (seg >= 0) & (seg < num_segments)
    out = x.new_zeros((num_segments,) + tuple(x.shape[1:]))
    x = torch.where(ok.view((-1,) + (1,) * (x.dim() - 1)), x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    return out.index_add(0, seg.clamp(0, num_segments - 1), x)


def combine_bags(vecs, ids, segment_ids, num_segments: int, combiner: str,
                 dtype):
    """Per-segment combine of looked-up vectors (shared by the dense and
    the mesh-sharded embedding-bag paths)."""
    if combiner not in ("sum", "mean", "sqrtn"):
        raise ValueError(f"unknown combiner {combiner!r}")
    sums = _segment_sum(vecs, segment_ids, num_segments)
    if combiner == "sum":
        return sums
    counts = _segment_sum(torch.ones(ids.shape, dtype=dtype,
                                     device=vecs.device),
                          segment_ids, num_segments)
    if combiner == "mean":
        return sums / torch.clamp(counts, min=1.0)[:, None]
    return sums * torch.rsqrt(torch.clamp(counts, min=1.0))[:, None]


def embedding_bag(table, ids, segment_ids, num_segments: int, *,
                  combiner: str = "sum"):
    """Lookup + per-segment combine, the CTR 'sparse feature bag' op.
    ids, segment_ids: [K] flat id/segment pairs."""
    vecs = table[ids.long()]
    return combine_bags(vecs, ids, segment_ids, num_segments, combiner,
                        table.dtype)


def shard_table_rows(table, mesh):
    """Place an embedding table row-sharded over the model axis (a
    DTensor; `parallel.sparse.shard_rows`, which also checks that the
    axis divides the vocab)."""
    from paddle_tpu_torch.parallel.sparse import shard_rows

    return shard_rows(table, mesh, MODEL_AXIS)


def one_hot_matmul_lookup(table, ids, *, dtype=None):
    """Lookup as one-hot @ table, accumulated in f32 and cast back to
    the table's dtype (numerically the dense lookup)."""
    v = table.shape[0]
    flat = ids.reshape(-1).long()
    oh = torch.nn.functional.one_hot(flat, v).to(dtype or table.dtype)
    out = torch.matmul(oh.float(), table.float())
    return out.reshape(tuple(ids.shape) + (table.shape[1],)).to(table.dtype)
