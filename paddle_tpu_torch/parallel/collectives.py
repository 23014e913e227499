"""Named communication primitives over a mesh axis (port of
`paddle_tpu.parallel.collectives`).

  all_reduce_sum/mean  -- the gradient exchange of sync SGD
  all_gather           -- gather fresh values from every shard
  reduce_scatter       -- ZeRO's sharded gradient exchange
  all_to_all           -- row exchanges (expert dispatch, Ulysses)
  ppermute_ring        -- the neighbour ring shift
  axis_index           -- this rank's position on the axis

The in-context forms are per-rank code over the process group of one
mesh axis (JAX's named collectives inside `shard_map`): they take the
axis name and use the mesh passed, or the one of the enclosing `with
mesh:` block. They are differentiable, each backward the collective's
transpose, with JAX's typing of what is replicated:

- all_reduce_sum's output is one replicated value, so its backward is
  the identity (psum transposes to a broadcast); `pvary` marks a
  replicated value that per-rank code uses differently on each rank:
  identity forward, its backward sums the cotangents over the axis;
- all_gather's backward is a reduce-scatter and reduce_scatter's an
  all-gather; all_to_all's is the inverse all-to-all; ppermute's is the
  opposite shift.

`launch_counts` counts the collectives each named primitive issues (a
differentiable one's backward counts too), so a caller can show what a
step moved; `reset_launch_counts` zeroes them. `bytes_moved` is the
bytes each sent, by primitive.

The whole-array forms (`device_all_reduce_mean`,
`device_broadcast_from`, `replicate`) take DTensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from paddle_tpu_torch.core.mesh import (DATA_AXIS, Mesh, NamedSharding, P,
                                        current_mesh, distribute)

Axes = Union[str, Sequence[str]]

#: collectives issued, by primitive (forward and backward alike)
launch_counts = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
                 "all_to_all": 0, "ppermute": 0}
#: bytes this rank sent, by primitive
bytes_moved = dict.fromkeys(launch_counts, 0)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
        bytes_moved[k] = 0


def _count(kind: str, x: torch.Tensor) -> None:
    launch_counts[kind] += 1
    bytes_moved[kind] += x.numel() * x.element_size()


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    return mesh if mesh is not None else current_mesh()


def _axes(axis: Axes) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(axis: Axes = DATA_AXIS, mesh: Optional[Mesh] = None) -> int:
    m = _mesh(mesh)
    n = 1
    for a in _axes(axis):
        n *= m.shape[a]
    return n


def axis_index(axis: Axes = DATA_AXIS, mesh: Optional[Mesh] = None) -> int:
    """This rank's index on the axis (on several axes: the first major,
    as JAX's axis_index of a tuple)."""
    m = _mesh(mesh)
    idx = 0
    for a in _axes(axis):
        idx = idx * m.shape[a] + m.axis_index(a)
    return idx


# ---- the raw collectives (no autograd) ----


def _raw_all_reduce(x, mesh: Mesh, axes: tuple):
    out = x.contiguous().clone()
    for a in axes:
        if mesh.shape[a] > 1:
            _count("all_reduce", out)
            dist.all_reduce(out, group=mesh.get_group(a))
    return out


def _raw_all_gather(x, mesh: Mesh, axis: str, dim: int):
    n = mesh.shape[axis]
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _count("all_gather", x)
    dist.all_gather_into_tensor(out, x, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def _raw_reduce_scatter(x, mesh: Mesh, axis: str, dim: int):
    n = mesh.shape[axis]
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axis!r} ({n})")
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _count("reduce_scatter", x)
    dist.reduce_scatter_tensor(out, x, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def _raw_all_to_all(x, mesh: Mesh, axis: str, split: int, concat: int):
    n = mesh.shape[axis]
    if n == 1:
        return x
    if x.shape[split] % n:
        raise ValueError(f"dim {split} of {tuple(x.shape)} does not split "
                         f"over {axis!r} ({n})")
    # chunks along `split` go to ranks 0..n-1; what arrives is stacked
    # by source rank and concatenated along `concat`
    chunks = x.reshape(x.shape[:split] + (n, x.shape[split] // n)
                       + x.shape[split + 1:]).movedim(split, 0).contiguous()
    out = torch.empty_like(chunks)
    _count("all_to_all", chunks)
    dist.all_to_all_single(out, chunks, group=mesh.get_group(axis))
    parts = list(out.unbind(0))
    return torch.cat(parts, dim=concat)


def _raw_ppermute(x, mesh: Mesh, axis: str, shift: int):
    n = mesh.shape[axis]
    if n == 1 or shift % n == 0:
        return x
    group = mesh.get_group(axis)
    me = mesh.axis_index(axis)
    ranks = dist.get_process_group_ranks(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    _count("ppermute", x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, ranks[(me + shift) % n], group),
        dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group),
    ])
    for r in reqs:
        r.wait()
    return out


# ---- differentiable in-context primitives ----


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _raw_all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _raw_all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_raw_reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim),
                None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _raw_reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_raw_all_gather(g, ctx.mesh, ctx.axis, ctx.dim),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.mesh, ctx.axis, ctx.split, ctx.concat = mesh, axis, split, concat
        return _raw_all_to_all(x, mesh, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_raw_all_to_all(g, ctx.mesh, ctx.axis, ctx.concat,
                                ctx.split), None, None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _raw_ppermute(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _raw_ppermute(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


def all_reduce_sum(x, axis: Axes = DATA_AXIS, *, mesh: Optional[Mesh] = None):
    """psum: the sum over the axis (several axes: over all of them)."""
    return _AllReduce.apply(x, _mesh(mesh), _axes(axis))


def all_reduce_mean(x, axis: Axes = DATA_AXIS, *,
                    mesh: Optional[Mesh] = None):
    return all_reduce_sum(x, axis, mesh=mesh) / axis_size(axis, mesh)


def pvary(x, axis: Axes = DATA_AXIS, *, mesh: Optional[Mesh] = None):
    """Mark a replicated value as varying over the axis: identity
    forward; the backward sums the cotangents over the axis, so each
    rank gets the whole gradient of a replicated input that per-rank
    code used differently on each rank."""
    return _PVary.apply(x, _mesh(mesh), _axes(axis))


def all_gather(x, axis: str = DATA_AXIS, *, tiled: bool = True,
               dim: int = 0, mesh: Optional[Mesh] = None):
    """Shards concatenated along `dim` in axis order (tiled), or stacked
    on a new leading dim (tiled=False)."""
    if not tiled:
        return _AllGather.apply(x[None], _mesh(mesh), axis, 0)
    return _AllGather.apply(x, _mesh(mesh), axis, dim)


def reduce_scatter(x, axis: str = DATA_AXIS, *, scatter_dimension: int = 0,
                   mesh: Optional[Mesh] = None):
    """psum_scatter (tiled): the sum over the axis, each rank keeping its
    own contiguous block of `scatter_dimension`."""
    return _ReduceScatter.apply(x, _mesh(mesh), axis, scatter_dimension)


def all_to_all(x, axis: str = DATA_AXIS, *, split_axis: int = 0,
               concat_axis: int = 0, mesh: Optional[Mesh] = None):
    """Tiled all-to-all: block j of `split_axis` goes to rank j; the
    blocks received are concatenated along `concat_axis` by source."""
    return _AllToAll.apply(x, _mesh(mesh), axis, split_axis, concat_axis)


def ppermute_ring(x, axis: str = DATA_AXIS, *, shift: int = 1,
                  mesh: Optional[Mesh] = None):
    """Rotate shards around the ring by `shift`: rank i's value goes to
    rank i + shift."""
    return _PPermute.apply(x, _mesh(mesh), axis, shift)


# ---- whole-array forms (DTensors on the mesh) ----


def device_all_reduce_mean(x, mesh: Mesh, axis: str = DATA_AXIS):
    """The mean of an axis-sharded DTensor's shards, each shard replaced
    by it (the sync-SGD exchange as one call)."""
    from torch.distributed.tensor import DTensor

    x = distribute(x, NamedSharding(mesh, P(axis)))
    local = all_reduce_mean(x.to_local(), axis, mesh=mesh)
    return DTensor.from_local(local, mesh.dtensor_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def device_broadcast_from(x, mesh: Mesh, axis: str = DATA_AXIS,
                          source: int = 0):
    """Shard `source`'s block of an axis-sharded DTensor, replicated."""
    from torch.distributed.tensor import DTensor

    x = distribute(x, NamedSharding(mesh, P(axis)))
    local = x.to_local()
    mask = 1.0 if axis_index(axis, mesh) == source else 0.0
    out = all_reduce_sum(local * mask, axis, mesh=mesh)
    return DTensor.from_local(out, mesh.dtensor_mesh,
                              mesh.placements(P()), run_check=False)


def replicate(x, mesh: Mesh):
    return distribute(x, NamedSharding(mesh, P()))


def shard_local(x, spec, *, mesh: Optional[Mesh] = None):
    """This rank's block of x under `spec` (per tensor dim: an axis, a
    tuple of axes or None), differentiably. A DTensor is redistributed
    to the spec and its local shard taken; a plain tensor is a replicated
    value (the same on every rank): it is `pvary`'d over the spec's axes
    (so its gradient comes back whole on every rank) and narrowed to the
    rank's block."""
    from torch.distributed.tensor import DTensor

    m = _mesh(mesh)
    spec = tuple(spec)
    if isinstance(x, DTensor):
        return x.redistribute(m.dtensor_mesh, m.placements(P(*spec))) \
            .to_local()
    axes = tuple(a for s in spec if s is not None for a in _axes(s)
                 if m.shape[a] > 1)
    if not axes:
        return x
    x = pvary(x, axes, mesh=m)
    for dim, s in enumerate(spec):
        if s is None:
            continue
        n = axis_size(s, m)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split over {s!r} ({n})")
        size = x.shape[dim] // n
        x = x.narrow(dim, axis_index(s, m) * size, size)
    return x


def from_local(local, spec, like_shape=None, *, mesh: Optional[Mesh] = None):
    """A DTensor of rank-local blocks placed by `spec` (differentiable);
    like_shape: the global shape (default: each sharded dim times its
    axis size)."""
    from torch.distributed.tensor import DTensor

    m = _mesh(mesh)
    spec = tuple(spec)
    if like_shape is None:
        like_shape = list(local.shape)
        for dim, s in enumerate(spec):
            if s is not None:
                like_shape[dim] *= axis_size(s, m)
    shape = torch.Size(like_shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, m.dtensor_mesh, m.placements(P(*spec)),
                              run_check=False, shape=shape, stride=stride)
