"""Sharded matmul primitives: ring collective matmul and blocked
streaming (port of `paddle_tpu.parallel.blocked_matmul`).

The global matmul is cut into per-shard block products, and operands
rotate around the ring of one mesh axis one block per step
(`collectives`' ring shift), so a step's transfer can be in flight
while the previous block's product runs:

  * `ring_matmul_gather` -- output-dim ring: x row-sharded [m, K], w
    column-sharded [K, n]; the x blocks travel both ways round the ring
    (ceil((p-1)/2) steps) and each arriving block's product lands in its
    output rows.
  * `ring_matmul_reduce` -- contracting-dim ring: x column-sharded
    [M, k], w row-sharded [k, N]; a per-block accumulator rides the ring
    reduce-scatter style and block c finishes at rank c.
  * `stream_matmul` -- w K-sharded and resident; the weight shards
    rotate while each rank multiplies the matching column block of its
    replicated x (at most two shards live per rank).
  * `tp_dense` -- the reduce ring as a row-parallel dense layer, the
    stage matmul of `parallel.pipeline`'s `tp_axis`.

The in-context forms are per-rank code over the axis' process group (a
`shard_map` body's counterpart): they take the axis name and the mesh
(or the enclosing `with mesh:`). With overlap=True and no gradient being
recorded, each ring step posts its `isend`/`irecv` before the current
block's product and waits after it; under autograd the step uses the
differentiable ring shift (`collectives.ppermute_ring`, whose backward
is the opposite shift), so gradients flow through every ring. The block
products are `torch.matmul` (JAX computes them with `jnp.dot` outside
any Pallas kernel), accumulated in at least f32 whatever the compute
dtype, and cast to the operands' result dtype.

`collective_matmul` and `blocked_matmul` are the whole-array wrappers:
full tensors (the same on every rank) or DTensors in, DTensors out,
placed as JAX's out_specs say.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from paddle_tpu_torch.core.mesh import Mesh, current_mesh
from paddle_tpu_torch.parallel import collectives as C


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    return mesh if mesh is not None else current_mesh()


def _acc_dtype(x, w):
    """Accumulate in at least f32 (bf16/f16 inputs upcast; f64 stays)."""
    return torch.promote_types(torch.float32,
                               torch.promote_types(x.dtype, w.dtype))


def _dot(a, b, acc_dtype):
    return torch.matmul(a.to(acc_dtype), b.to(acc_dtype))


def matmul_reference(x, w):
    """The plain oracle: one matmul with the same >= f32 accumulation
    as the sharded primitives."""
    acc = _acc_dtype(x, w)
    return _dot(x, w, acc).to(torch.promote_types(x.dtype, w.dtype))


def _recording(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)


def _ring_step(x, mesh: Mesh, axis: str, shift: int, compute, overlap,
               differentiable: bool):
    """Shift x one ring step by `shift` while `compute()` runs. Returns
    (shifted x, compute()). Overlapped: the sends are posted, compute
    runs, then they are waited for; under autograd, the differentiable
    shift first."""
    if differentiable or not overlap:
        moved = C.ppermute_ring(x, axis, shift=shift, mesh=mesh)
        return moved, compute()
    n = mesh.shape[axis]
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    me = mesh.axis_index(axis)
    x = x.contiguous()
    out = torch.empty_like(x)
    C._count("ppermute", x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, ranks[(me + shift) % n], group),
        dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group),
    ])
    done = compute()
    for r in reqs:
        r.wait()
    return out, done


class _GatherReplicated(torch.autograd.Function):
    """all_gather of per-rank row blocks into a value every rank then
    uses alike (replicated): the backward keeps this rank's block of the
    (replicated) cotangent, where `collectives.all_gather`'s would sum
    every rank's."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return C._raw_all_gather(x, mesh, axis, 0)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axis)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None, None


# ---------------------------------------------------------------------------
# in-context primitives (per-rank code over one mesh axis)
# ---------------------------------------------------------------------------


def ring_matmul_gather(x_loc, w_loc, *, axis: str, overlap: bool = True,
                       mesh: Optional[Mesh] = None):
    """Collective matmul over the OUTPUT (row) dim of x. x_loc: this
    rank's row block [m, K] of the global [p*m, K] x; w_loc: its column
    block [K, n]. Returns [p*m, n], the full-height slab of this rank's
    output columns. overlap=True runs the bidirectional ring (an even
    ring takes one more forward hop for the antipodal block);
    overlap=False all-gathers x, then one matmul."""
    m_ = _mesh(mesh)
    p = m_.shape[axis]
    acc = _acc_dtype(x_loc, w_loc)
    out_dtype = torch.promote_types(x_loc.dtype, w_loc.dtype)
    if not overlap or p == 1:
        xg = C.all_gather(x_loc, axis, dim=0, mesh=m_)
        return _dot(xg, w_loc, acc).to(out_dtype)
    diff = _recording(x_loc, w_loc)
    me = m_.axis_index(axis)
    blocks = {me: _dot(x_loc, w_loc, acc)}
    fwd = bwd = x_loc  # after s hops: the blocks of ranks me - s, me + s
    for s in range(1, (p - 1) // 2 + 1):
        fwd, _ = _ring_step(fwd, m_, axis, 1, lambda: None, overlap, diff)
        bwd, prod = _ring_step(bwd, m_, axis, -1,
                               lambda f=fwd: _dot(f, w_loc, acc), overlap,
                               diff)
        blocks[(me - s) % p] = prod
        blocks[(me + s) % p] = _dot(bwd, w_loc, acc)
    if p % 2 == 0:
        fwd, _ = _ring_step(fwd, m_, axis, 1, lambda: None, overlap, diff)
        blocks[(me - p // 2) % p] = _dot(fwd, w_loc, acc)
    return torch.cat([blocks[j] for j in range(p)]).to(out_dtype)


def ring_matmul_reduce(x_loc, w_loc, *, axis: str, overlap: bool = True,
                       mesh: Optional[Mesh] = None):
    """Collective matmul over the CONTRACTING dim. x_loc: this rank's
    column block [M, k] of the global [M, p*k] x (M % p == 0); w_loc:
    the matching row block [k, N]. Returns this rank's ROW block
    [M/p, N] of sum_j x_j @ w_j. overlap=True rides a per-block
    accumulator round the ring (each rank's next product is independent
    of the hand-off, so they overlap); overlap=False forms the full
    [M, N] partial, then one reduce-scatter."""
    m_ = _mesh(mesh)
    p = m_.shape[axis]
    big_m = x_loc.shape[0]
    if big_m % p != 0:
        raise ValueError(
            f"ring_matmul_reduce needs M % p == 0, got M={big_m} over "
            f"{p} '{axis}' ranks")
    acc_dtype = _acc_dtype(x_loc, w_loc)
    out_dtype = torch.promote_types(x_loc.dtype, w_loc.dtype)
    if not overlap or p == 1:
        full = _dot(x_loc, w_loc, acc_dtype)
        if p == 1:
            return full.to(out_dtype)
        return C.reduce_scatter(full, axis, scatter_dimension=0,
                                mesh=m_).to(out_dtype)
    diff = _recording(x_loc, w_loc)
    me = m_.axis_index(axis)
    m = big_m // p

    def part(blk):
        """This rank's contribution to output row block blk."""
        row0 = (blk % p) * m
        return _dot(x_loc[row0:row0 + m], w_loc, acc_dtype)

    # the accumulator that started at rank me + 1 arrives last, holding
    # block me: each rank ends with its own finished block
    acc = part(me - 1)
    for s in range(1, p):
        acc, nxt = _ring_step(acc, m_, axis, 1,
                              lambda s=s: part(me - 1 - s), overlap, diff)
        acc = acc + nxt
    return acc.to(out_dtype)


def stream_matmul(x, w_loc, *, axis: str, mesh: Optional[Mesh] = None):
    """Blocked matmul for a weight larger than one device: w_loc [k, N]
    is this rank's resident K-block (globally P(axis, None)); x
    [B, p*k] is replicated. The weight shards rotate round the ring and
    each rank multiplies the matching column block of x; no rank holds
    more than two shards. Returns the full [B, N] on every rank."""
    m_ = _mesh(mesh)
    p = m_.shape[axis]
    me = m_.axis_index(axis)
    k = w_loc.shape[0]
    acc_dtype = _acc_dtype(x, w_loc)
    out_dtype = torch.promote_types(x.dtype, w_loc.dtype)
    diff = _recording(x, w_loc)

    def xblk(blk):
        col0 = (blk % p) * k
        return x[:, col0:col0 + k]

    # after s hops this rank holds the shard of rank me - s; the next
    # shard is in flight while the current one's product runs
    w_cur, acc = w_loc, None
    for s in range(p):
        prod = lambda w=w_cur, s=s: _dot(xblk(me - s), w, acc_dtype)
        if s + 1 < p:
            w_cur, part = _ring_step(w_cur, m_, axis, 1, prod, True, diff)
        else:
            part = prod()
        acc = part if acc is None else acc + part
    return acc.to(out_dtype)


def tp_dense(x, w_loc, *, axis: str, overlap: bool = True,
             mesh: Optional[Mesh] = None):
    """Row-parallel dense layer: x [B, d] replicated over the axis,
    w_loc [d/p, N] this rank's row block of the [d, N] weight; returns
    [B, N], replicated. overlap=False: the local partial product, then
    one all-reduce. overlap=True: `ring_matmul_reduce`, then the row
    blocks all-gathered; a batch the axis does not tile takes the
    all-reduce form. x enters through `pvary`, so its gradient comes
    back whole on every rank (each rank differentiates its slice)."""
    m_ = _mesh(mesh)
    p = m_.shape[axis]
    me = m_.axis_index(axis)
    k = w_loc.shape[0]
    out_dtype = torch.promote_types(x.dtype, w_loc.dtype)
    if p > 1:
        x = C.pvary(x, axis, mesh=m_)
    x_me = x[:, me * k:(me + 1) * k]
    if not overlap or p == 1 or x.shape[0] % p != 0:
        acc = _dot(x_me, w_loc, _acc_dtype(x, w_loc))
        return C.all_reduce_sum(acc, axis, mesh=m_).to(out_dtype)
    rows = ring_matmul_reduce(x_me, w_loc, axis=axis, overlap=True,
                              mesh=m_)
    return _GatherReplicated.apply(rows, m_, axis)


# ---------------------------------------------------------------------------
# whole-array wrappers
# ---------------------------------------------------------------------------


def collective_matmul(mesh: Mesh, *, axis: str, mode: str = "reduce",
                      overlap: bool = True) -> Callable:
    """fn(x, w) -> x @ w over global tensors (full, the same on every
    rank, or DTensors), ring-sharded inside. mode="gather": x split by
    rows and w by columns (`ring_matmul_gather`), the result a DTensor
    split by columns; mode="reduce": the contracting dim split
    (`ring_matmul_reduce`), the result split by rows."""
    if mode == "gather":
        inner, specs, out = ring_matmul_gather, ((axis, None),
                                                 (None, axis)), (None, axis)
    elif mode == "reduce":
        inner, specs, out = ring_matmul_reduce, ((None, axis),
                                                 (axis, None)), (axis, None)
    else:
        raise ValueError(
            f"unknown mode {mode!r}: expected 'gather' or 'reduce'")

    def fn(x, w):
        x_loc = C.shard_local(x, specs[0], mesh=mesh)
        w_loc = C.shard_local(w, specs[1], mesh=mesh)
        got = inner(x_loc, w_loc, axis=axis, overlap=overlap, mesh=mesh)
        return C.from_local(got, out, mesh=mesh)

    return fn


def blocked_matmul(mesh: Mesh, *, axis: str) -> Callable:
    """fn(x, w) -> x @ w with w K-sharded and resident
    (`stream_matmul`): the weight is never whole on any rank; x and the
    result are replicated (plain tensors)."""

    def fn(x, w):
        if hasattr(x, "full_tensor"):
            x = x.full_tensor()
        w_loc = C.shard_local(w, (axis, None), mesh=mesh)
        return stream_matmul(x, w_loc, axis=axis, mesh=mesh)

    return fn
