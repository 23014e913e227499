"""Sharded sparse-embedding training (port of `paddle_tpu.parallel.sparse`).

An embedding table lives row-sharded over the mesh `model` axis (a
DTensor, `Shard(0)` on that axis: rank r of the axis holds rows
[r * V/n, (r+1) * V/n)). The lookups and updates are per-rank code over
the axis' process group, as `parallel.collectives` writes JAX's
`shard_map` bodies:

- `sharded_lookup`: each rank takes from its own rows, out-of-range ids
  masked to zero, and one all-reduce (psum) over the axis assembles the
  full vectors. Differentiable: the table's gradient is each rank's
  local scatter-add of the (replicated) row gradients.
- `alltoall_lookup`: the ids are split over the axis; each rank routes
  its ids to their owners in a fixed [n, capacity] buffer, one
  `all_to_all_single` ships the requests and one ships the vectors back
  (K * D in all instead of the psum's n * K * D). Ids past a
  destination's capacity are dropped (zero vectors) and counted.
  Differentiable through the inverse exchange.
- `alltoall_push_row_grads`, `rowwise_sgd_update`: row-sparse SGD on the
  touched rows only, in place on each rank's shard; no dense [V, D]
  gradient exists.
- `ShardedEmbedding` and `HostOffloadEmbedding` expose the same
  `LookupSurface`. The host-offload table lives in (pinned, when the
  rows go to the card) host memory: a lookup gathers the touched rows
  on the host and copies only those [K, D] rows to the device; the row
  update scatter-adds back on the host. The device never holds the
  [V, D] table.

Updates happen IN PLACE (the JAX functions return a new table) and
return the table, as the port's optimizers do.
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.mesh import MODEL_AXIS, Mesh, NamedSharding, P
from paddle_tpu_torch.core.mesh import distribute, gather_full
from paddle_tpu_torch.ops.embedding import combine_bags
from paddle_tpu_torch.parallel import collectives as C


@runtime_checkable
class LookupSurface(Protocol):
    """The one lookup surface every embedding backing exposes
    (`ShardedEmbedding`, `HostOffloadEmbedding`):

    - `lookup(table, ids)`: [K] ids -> [K, D] rows on the device;
      out-of-range ids (e.g. -1 padding) give zero vectors;
    - `apply_row_grads(table, ids, row_grads, lr)`: row-sparse SGD,
      padding ids dropped (`masked_row_delta`), returns the table;
    - `alltoall_lookup` / `alltoall_push_row_grads`: the capacity-
      bounded forms the distributed CTR call sites use; single-process
      backings honor `return_overflow` with a zero counter."""

    vocab: int
    dim: int

    def init(self, rng): ...

    def lookup(self, table, ids): ...

    def apply_row_grads(self, table, ids, row_grads, lr): ...

    def alltoall_lookup(self, table, ids, *, capacity=None,
                        return_overflow: bool = False): ...

    def alltoall_push_row_grads(self, table, ids, row_grads, lr, *,
                                capacity=None): ...


def shard_rows(table, mesh: Mesh, axis: str = MODEL_AXIS):
    """Row-shard a [V, D] table over a mesh axis (a DTensor); V must
    divide evenly (pad the vocab up). table: the full value, the same on
    every rank, or a DTensor."""
    n = mesh.shape[axis]
    if table.shape[0] % n != 0:
        raise ValueError(
            f"vocab {table.shape[0]} not divisible by {axis} axis size {n}; "
            f"pad the table")
    return distribute(table, NamedSharding(mesh, P(axis, None)))


def _ids(ids):
    """ids as a plain tensor: a DTensor is gathered."""
    return gather_full(ids)


def _table_local(table, mesh: Mesh, axis: str):
    """This rank's rows of a table placed by `shard_rows` (differentiable;
    an in-place update of it updates the table). A plain tensor is taken
    as the whole table only where the axis has one rank."""
    if hasattr(table, "to_local"):
        want = mesh.placements(P(axis, None))
        if tuple(table.placements) != want:
            raise ValueError(f"table placed {table.placements}, not row-"
                             f"sharded over {axis!r} ({want}): place it "
                             f"with shard_rows")
        return table.to_local()
    if mesh.shape[axis] != 1:
        raise ValueError(f"a plain table over a {mesh.shape[axis]}-rank "
                         f"{axis!r} axis: place it with shard_rows")
    return table


def _masked_take(tab_shard, ids_global, lo: int, rows_per_shard: int):
    """Rows of this shard for global ids; ids it does not own give
    zeros (differentiable in the shard)."""
    local = ids_global.long() - lo
    ok = (local >= 0) & (local < rows_per_shard)
    safe = local.clamp(0, rows_per_shard - 1)
    vecs = tab_shard[safe]
    return torch.where(ok[..., None], vecs,
                       torch.zeros((), dtype=vecs.dtype, device=vecs.device))


def sharded_lookup(table, ids, mesh: Mesh, *, axis: str = MODEL_AXIS):
    """Lookup into a row-sharded table: local masked take + one psum.
    ids: int tensor of any shape, the same on every rank. Returns
    [*ids.shape, D], replicated over the axis (a plain tensor).
    Out-of-range ids (negative or >= V) give zero vectors."""
    n = mesh.shape[axis]
    rows_per_shard = table.shape[0] // n
    tab = _table_local(table, mesh, axis)
    ids = _ids(ids).to(tab.device)
    lo = mesh.axis_index(axis) * rows_per_shard
    vecs = _masked_take(tab, ids, lo, rows_per_shard)
    return C.all_reduce_sum(vecs, axis, mesh=mesh)


def _route_to_owners(ids_local, n: int, rows_per_shard: int, capacity: int):
    """Bucket local ids by owning shard into a fixed [n, capacity] send
    buffer (pad id -1). Returns (send_ids, order, pos_in_run, kept,
    overflow): ids past `capacity` for one owner are dropped and
    counted; invalid ids go to a virtual owner n and are never sent. No
    host sync: the dropped slots land in a spill row and column that
    are cut off."""
    k = ids_local.shape[0]
    dev = ids_local.device
    ids_local = ids_local.long()
    owner = torch.where((ids_local >= 0) & (ids_local < n * rows_per_shard),
                        torch.div(ids_local, rows_per_shard,
                                  rounding_mode="floor"),
                        torch.full_like(ids_local, n))
    order = torch.sort(owner, stable=True).indices
    sorted_ids = ids_local[order]
    sorted_owner = owner[order]
    first_idx = torch.searchsorted(sorted_owner,
                                   torch.arange(n + 1, device=dev))
    pos_in_run = torch.arange(k, device=dev) - first_idx[sorted_owner]
    kept = (pos_in_run < capacity) & (sorted_owner < n)
    row = torch.where(kept, sorted_owner, torch.full_like(sorted_owner, n))
    col = torch.where(kept, pos_in_run, torch.full_like(pos_in_run,
                                                        capacity))
    send = torch.full((n + 1, capacity + 1), -1, dtype=torch.long,
                      device=dev)
    send[row, col] = torch.where(kept, sorted_ids,
                                 torch.full_like(sorted_ids, -1))
    counts = first_idx[1:] - first_idx[:-1]
    overflow = torch.clamp(counts[:n] - capacity, min=0).sum()
    return send[:n, :capacity], order, pos_in_run, kept, overflow


def _split_ids(ids, mesh: Mesh, axis: str):
    """This rank's contiguous block of the flat ids [K] (K must divide
    over the axis)."""
    n = mesh.shape[axis]
    ids = _ids(ids)
    k = ids.shape[0]
    if k % n != 0:
        raise ValueError(f"ids size {k} not divisible by axis size {n}")
    k_loc = k // n
    i = mesh.axis_index(axis)
    return ids[i * k_loc:(i + 1) * k_loc]


def alltoall_lookup_local(table, ids_local, mesh: Mesh, *,
                          axis: str = MODEL_AXIS,
                          capacity: Optional[int] = None):
    """The per-rank body of `alltoall_lookup`: this rank's ids
    [K/n] -> (rows [K/n, D], this rank's overflow count; summed over the
    axis, the global one). Differentiable in the table (the gradient
    travels back by the inverse all-to-all)."""
    n = mesh.shape[axis]
    rows_per_shard = table.shape[0] // n
    tab = _table_local(table, mesh, axis)
    ids_local = ids_local.to(tab.device)
    k_loc, dim = ids_local.shape[0], tab.shape[1]
    cap = capacity if capacity is not None else k_loc
    lo = mesh.axis_index(axis) * rows_per_shard
    send, order, pos_in_run, kept, overflow = _route_to_owners(
        ids_local, n, rows_per_shard, cap)
    # ship id requests to their owners, serve them, ship the rows back
    recv = C._raw_all_to_all(send, mesh, axis, 0, 0)            # [n, cap]
    vecs = _masked_take(tab, recv, lo, rows_per_shard)         # [n, cap, D]
    back = C.all_to_all(vecs, axis, split_axis=0, concat_axis=0, mesh=mesh)
    owner_sorted = torch.div(ids_local.long()[order], rows_per_shard,
                             rounding_mode="floor").clamp(0, n - 1)
    got = back[owner_sorted, pos_in_run.clamp(0, cap - 1)]
    got = torch.where(kept[:, None], got,
                      torch.zeros((), dtype=got.dtype, device=got.device))
    out = got.new_zeros((k_loc, dim)).index_copy(0, order, got)
    return out, overflow


def alltoall_lookup(table, ids, mesh: Mesh, *, axis: str = MODEL_AXIS,
                    capacity: Optional[int] = None,
                    return_overflow: bool = False):
    """Lookup into a row-sharded table by owner routing and all-to-all.

    table: [V, D] from `shard_rows`. ids: [K] ints, the full value on
    every rank (or a DTensor); rank i of the axis looks up its block
    [i*K/n, (i+1)*K/n). capacity: routing slots per (source,
    destination), default K/n (lossless); ids past it are dropped (zero
    vectors), counted by return_overflow=True.

    Returns [K, D] as a DTensor sharded over the axis (like the ids);
    with return_overflow, (rows, overflow) where overflow is the global
    count of dropped ids (a 0-d tensor, 0 when the capacity held)."""
    out, overflow = alltoall_lookup_local(
        table, _split_ids(ids, mesh, axis), mesh, axis=axis,
        capacity=capacity)
    rows = C.from_local(out, (axis, None), mesh=mesh)
    if not return_overflow:
        return rows
    return rows, C._raw_all_reduce(overflow, mesh, (axis,))


def alltoall_push_row_grads_local(table, ids_local, grads_local, lr,
                                  mesh: Mesh, *, axis: str = MODEL_AXIS,
                                  capacity: Optional[int] = None):
    """The per-rank body of `alltoall_push_row_grads`: this rank's ids
    [K/n] and row gradients [K/n, D]."""
    n = mesh.shape[axis]
    rows_per_shard = table.shape[0] // n
    tab = _table_local(table, mesh, axis)
    ids_local = ids_local.to(tab.device)
    grads_local = grads_local.to(tab.device)
    k_loc, dim = ids_local.shape[0], tab.shape[1]
    cap = capacity if capacity is not None else k_loc
    lo = mesh.axis_index(axis) * rows_per_shard
    with torch.no_grad():
        send_ids, order, pos_in_run, kept, _ = _route_to_owners(
            ids_local, n, rows_per_shard, cap)
        # the gradients in the same [n, cap, D] layout as the ids
        sorted_owner = torch.div(ids_local.long()[order], rows_per_shard,
                                 rounding_mode="floor").clamp(0, n - 1)
        row = torch.where(kept, sorted_owner, torch.full_like(sorted_owner,
                                                              n))
        col = torch.where(kept, pos_in_run, torch.full_like(pos_in_run, cap))
        send_g = grads_local.new_zeros((n + 1, cap + 1, dim))
        send_g[row, col] = grads_local[order]
        send_g = send_g[:n, :cap]
        recv_ids = C._raw_all_to_all(send_ids, mesh, axis, 0, 0)
        recv_g = C._raw_all_to_all(send_g, mesh, axis, 0, 0)
        flat_ids = recv_ids.reshape(-1)
        local = flat_ids - lo
        ok = (flat_ids >= 0) & (local >= 0) & (local < rows_per_shard)
        safe = local.clamp(0, rows_per_shard - 1)
        contrib = torch.where(ok[:, None], recv_g.reshape(-1, dim),
                              torch.zeros((), dtype=recv_g.dtype,
                                          device=recv_g.device))
        tab.index_add_(0, safe, (-lr * contrib).to(tab.dtype))
    return table


def alltoall_push_row_grads(table, ids, row_grads, lr, mesh: Mesh, *,
                            axis: str = MODEL_AXIS,
                            capacity: Optional[int] = None):
    """SGD of only the touched rows with owner-routed gradients (the
    push mirroring `alltoall_lookup`). ids [K] and row_grads [K, D]: the
    full values on every rank (or DTensors split over the axis, as
    `alltoall_lookup` returns them); gradients for the same row from
    different ranks add. Updates the table in place and returns it."""
    g = row_grads.to_local() if hasattr(row_grads, "to_local") else None
    ids_local = _split_ids(ids, mesh, axis)
    if g is None:
        n = mesh.shape[axis]
        k_loc = row_grads.shape[0] // n
        i = mesh.axis_index(axis)
        g = row_grads[i * k_loc:(i + 1) * k_loc]
    return alltoall_push_row_grads_local(table, ids_local, g, lr, mesh,
                                         axis=axis, capacity=capacity)


def sharded_embedding_bag(table, ids, segment_ids, num_segments: int,
                          mesh: Mesh, *, axis: str = MODEL_AXIS,
                          combiner: str = "sum"):
    """Bag-combine on top of `sharded_lookup` (the segment sum after the
    psum, so each shard moves its [K, D] vectors once)."""
    vecs = sharded_lookup(table, ids, mesh, axis=axis)
    return combine_bags(vecs, _ids(ids).to(vecs.device),
                        _ids(segment_ids).to(vecs.device), num_segments,
                        combiner, vecs.dtype)


def masked_row_delta(num_rows: int, dtype, ids, row_grads, lr):
    """(safe_ids, -lr * masked_grads): the one home of the padding-id
    rule. Out-of-range ids (e.g. -1 padding) contribute zero and are
    clipped in bounds, so a scatter-add cannot wrap them."""
    ids = ids.long()
    in_range = (ids >= 0) & (ids < num_rows)
    safe = ids.clamp(0, num_rows - 1)
    contrib = torch.where(in_range[:, None], row_grads,
                          torch.zeros((), dtype=row_grads.dtype,
                                      device=row_grads.device))
    return safe, (-lr * contrib).to(dtype)


def rowwise_sgd_update(table, ids, row_grads, lr, mesh: Optional[Mesh] = None,
                       *, axis: str = MODEL_AXIS):
    """SGD of only the touched rows (the SelectedRows update). ids [K]
    (duplicates add), row_grads [K, D], both the same on every rank.
    With a mesh each rank adds into its own rows. In place; returns the
    table."""
    with torch.no_grad():
        if mesh is None:
            safe, delta = masked_row_delta(table.shape[0], table.dtype,
                                           ids.to(table.device),
                                           row_grads.to(table.device), lr)
            return table.index_add_(0, safe, delta)
        n = mesh.shape[axis]
        rows_per_shard = table.shape[0] // n
        tab = _table_local(table, mesh, axis)
        ids_g = _ids(ids).to(tab.device).long()
        grads_g = _ids(row_grads).to(tab.device)
        local = ids_g - mesh.axis_index(axis) * rows_per_shard
        ok = (local >= 0) & (local < rows_per_shard)
        safe = local.clamp(0, rows_per_shard - 1)
        contrib = torch.where(ok[:, None], grads_g,
                              torch.zeros((), dtype=grads_g.dtype,
                                          device=grads_g.device))
        tab.index_add_(0, safe, (-lr * contrib).to(tab.dtype))
    return table


def unique_rows_grad(ids, row_grads, max_unique: Optional[int] = None,
                     *, return_overflow: bool = False):
    """Deduplicate (ids, grads) into (unique_ids, summed_grads) of a
    static size (the SelectedRows merge): unique ids ascending, padding
    slots id 0 with zero gradient. A batch with more than `max_unique`
    distinct ids keeps the smallest ones; return_overflow=True adds the
    count of dropped distinct ids (0 when the bound held)."""
    flat = ids.reshape(-1).long()
    if max_unique is None:
        max_unique = flat.numel()
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    uids = flat.new_zeros((max_unique,))
    m = min(max_unique, uniq.numel())
    uids[:m] = uniq[:m]
    keep = inv < max_unique
    g = row_grads.reshape(flat.numel(), -1)
    summed = g.new_zeros((max_unique, g.shape[1])).index_add(
        0, inv.clamp(max=max_unique - 1),
        torch.where(keep[:, None], g, torch.zeros((), dtype=g.dtype,
                                                  device=g.device)))
    summed = summed.reshape((max_unique,) + tuple(row_grads.shape[1:]))
    if return_overflow:
        overflow = torch.clamp(torch.tensor(uniq.numel() - max_unique),
                               min=0)
        return uids, summed, overflow
    return uids, summed


def _normal_table(rng, vocab: int, dim: int, scale: float) -> torch.Tensor:
    """[vocab, dim] f32 N(0, scale^2) on the CPU from a seed or a CPU
    `torch.Generator`."""
    gen = rng
    if not isinstance(rng, torch.Generator):
        gen = torch.Generator()
        gen.manual_seed(int(rng))
    return torch.randn((vocab, dim), generator=gen,
                       dtype=torch.float32) * scale


class ShardedEmbedding:
    """A row-sharded table's vocab, dim and mesh placement, for models
    that train large sparse tables."""

    def __init__(self, vocab: int, dim: int, mesh: Mesh, *,
                 axis: str = MODEL_AXIS, name: str = "embedding",
                 init_scale: float = 0.01):
        n = mesh.shape[axis]
        self.padded_vocab = ((vocab + n - 1) // n) * n
        self.vocab, self.dim, self.mesh, self.axis = vocab, dim, mesh, axis
        self.name = name
        self.init_scale = init_scale

    def init(self, rng):
        """Draw over the real vocab (a seed or a CPU torch.Generator),
        zero-pad to the sharded row count, place row-sharded. Pad rows
        are unreachable: ids are < vocab."""
        table = _normal_table(rng, self.vocab, self.dim, self.init_scale)
        table = torch.cat([table, table.new_zeros(
            (self.padded_vocab - self.vocab, self.dim))])
        return self.place(table)

    def place(self, table):
        """A full [padded_vocab, D] table (a host value, e.g. from the
        weight bridge) placed row-sharded on the mesh's device."""
        return shard_rows(table.to(self.mesh.device), self.mesh, self.axis)

    def lookup(self, table, ids):
        return sharded_lookup(table, ids, self.mesh, axis=self.axis)

    def alltoall_lookup(self, table, ids, *, capacity=None,
                        return_overflow=False):
        """Owner-routed lookup (K * D exchange)."""
        return alltoall_lookup(table, ids, self.mesh, axis=self.axis,
                               capacity=capacity,
                               return_overflow=return_overflow)

    def alltoall_push_row_grads(self, table, ids, row_grads, lr, *,
                                capacity=None):
        return alltoall_push_row_grads(
            table, ids, row_grads, lr, self.mesh, axis=self.axis,
            capacity=capacity)

    def bag(self, table, ids, segment_ids, num_segments, combiner="sum"):
        return sharded_embedding_bag(
            table, ids, segment_ids, num_segments, self.mesh,
            axis=self.axis, combiner=combiner)

    def apply_row_grads(self, table, ids, row_grads, lr):
        return rowwise_sgd_update(
            table, ids, row_grads, lr, self.mesh, axis=self.axis)


# ---------------------------------------------------------------------
# host-offloaded tables (> device memory)
# ---------------------------------------------------------------------


class HostOffloadEmbedding:
    """An embedding table in host memory whose touched rows go to the
    device per step.

    The table is a CPU tensor, pinned when the rows go to the card (so
    the row copies are DMA); a lookup gathers the [K, D] touched rows on
    the host and copies only those to the device, and the row-sparse
    update scatter-adds back on the host. The same `LookupSurface` as
    `ShardedEmbedding`, single-process, plus the cache-backing methods
    (pull_rows / owner_of / n_shards / poll_watermarks / shard_failovers
    / update) in their single-authority form.

    device: where lookups land (None -> cuda; raises without a card)."""

    def __init__(self, vocab: int, dim: int, *, init_scale: float = 0.01,
                 name: str = "host_embedding", device=None):
        self.vocab, self.dim = vocab, dim
        self.init_scale = init_scale
        self.name = name
        self.device = resolve_device(device)

    def _host(self, table: torch.Tensor) -> torch.Tensor:
        """table on the host, pinned when the device is the card."""
        table = table.detach().cpu().contiguous()
        if self.device.type == "cuda" and not table.is_pinned():
            table = table.pin_memory()
        return table

    def init(self, rng):
        """Draw the table on the host (a seed or a CPU torch.Generator):
        a table larger than the device must never materialize there."""
        return self.place(_normal_table(rng, self.vocab, self.dim,
                                        self.init_scale))

    def place(self, table):
        """A full [V, D] table (e.g. from the weight bridge) in host
        memory."""
        if tuple(table.shape) != (self.vocab, self.dim):
            raise ValueError(f"table {tuple(table.shape)} is not "
                             f"({self.vocab}, {self.dim})")
        return self._host(table)

    def lookup(self, table, ids):
        """ids [K] -> rows [K, D] on the device: the gather runs on the
        host, so only K * D values cross to the device. Out-of-range ids
        give zero vectors."""
        ids = ids.reshape(-1)
        in_range = ((ids >= 0) & (ids < self.vocab)).to(self.device)
        ids_h = ids.long().clamp(0, self.vocab - 1).cpu()
        rows = table.index_select(0, ids_h)
        if self.device.type == "cuda":
            rows = rows.pin_memory().to(self.device, non_blocking=True)
        return rows.masked_fill_(~in_range[:, None], 0)

    def apply_row_grads(self, table, ids, row_grads, lr):
        """Row-sparse SGD on the host copy: the [K, D] gradients cross to
        the host, where the padding rule (`masked_row_delta`) and the
        scatter-add run; the device allocates nothing. In place; returns
        the table."""
        with torch.no_grad():
            safe, delta = masked_row_delta(
                self.vocab, table.dtype, ids.reshape(-1).cpu(),
                row_grads.detach().cpu(), lr if not isinstance(
                    lr, torch.Tensor) else lr.cpu())
            table.index_add_(0, safe, delta)
        return table

    def alltoall_lookup(self, table, ids, *, capacity=None,
                        return_overflow: bool = False):
        out = self.lookup(table, ids)
        if return_overflow:
            return out, torch.zeros((), dtype=torch.int64,
                                    device=out.device)
        return out

    def alltoall_push_row_grads(self, table, ids, row_grads, lr, *,
                                capacity=None):
        return self.apply_row_grads(table, ids, row_grads, lr)

    # -- cache-backing surface (single-authority forms) -----------------

    def pull_rows(self, table, ids):
        """[K] ids -> ([K, D] float32 host rows, watermarks=None): no
        push ledger, so a cache in front runs in static-source mode."""
        rows = self.lookup(table, torch.as_tensor(np.asarray(ids)))
        return rows.detach().cpu().numpy().astype(np.float32), None

    def owner_of(self, ids) -> np.ndarray:
        ids = np.asarray(ids).reshape(-1)
        owner = np.zeros(ids.shape[0], np.int64)
        owner[(ids < 0) | (ids >= self.vocab)] = -1
        return owner

    @property
    def n_shards(self) -> int:
        return 1

    def poll_watermarks(self, table):
        return None

    def shard_failovers(self):
        return [0]

    def update(self, table, ids, row_grads, lr):
        """The row-sparse update whose table stays in host memory (the
        form to call between steps): `apply_row_grads`, which already
        updates the host table in place."""
        return self.apply_row_grads(table, ids, row_grads, lr)
