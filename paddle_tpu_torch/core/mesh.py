"""Device mesh (port of `paddle_tpu.core.mesh`) over `torch.distributed`.

One named mesh over every rank of the default process group, with the
JAX package's axis names:

  data  -- batch-sharded data parallelism
  model -- tensor (weight) sharding
  seq   -- sequence / context parallelism

`Mesh` wraps a `torch.distributed.device_mesh.DeviceMesh` of those
dims. Rank r sits where JAX's `np.array(devices).reshape(data, model,
seq)` puts device r (row-major). The two halves of the distributed
layer read it two ways:

- declared placement (`parallel.sharding`, `parallel.train_step`):
  a spec `P(...)` names a mesh axis per tensor dim, and `placements`
  turns it into DTensor placements (`Shard(i)` on the named mesh dims,
  `Replicate()` elsewhere). DTensors live on `dtensor_mesh`, the
  sub-mesh of the axes larger than 1: DTensor enumerates its sharding
  strategies over every mesh dim, and a size-1 dim changes no
  placement but multiplies that work.
- explicit SPMD code (`parallel.collectives` and what uses them): the
  process group of one axis (`get_group`) and this rank's index on it
  (`axis_index`). `with mesh:` makes it the mesh the collectives use
  when they are not given one, as a `shard_map` body names the axes of
  its enclosing mesh.

DTensor takes no sharding rule for an operator it does not know: the
rules of kernel A (`paddle_tpu_torch::flash_fwd`) and of kernels B and C
(`paddle_tpu_torch::ragged_walk`, `ragged_walk_int8`) are registered
here, when a mesh is first built.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.devices import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names (the dim split
    over several axes, the first major) or None (not split)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape; -1 in `data` means "all remaining devices"."""

    data: int = -1
    model: int = 1
    seq: int = 1

    def resolve(self, n_devices: int) -> tuple:
        model, seq = self.model, self.seq
        data = self.data
        if data == -1:
            if n_devices % (model * seq) != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by model*seq={model * seq}"
                )
            data = n_devices // (model * seq)
        if data * model * seq != n_devices:
            raise ValueError(
                f"mesh {data}x{model}x{seq} != {n_devices} devices"
            )
        return (data, model, seq)


_CURRENT: list = []


class Mesh:
    """A named mesh over every rank (see the module docstring).

    shape: {axis: size} in mesh order, as JAX's `Mesh.shape`. device:
    this rank's device (cuda:local rank, or the CPU)."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        active = tuple(a for a in self.axis_names if self.shape[a] > 1)
        self.dtensor_axes = active or self.axis_names[:1]
        #: False on a rank the mesh leaves out (a mesh over some ranks)
        self.contains_me = device_mesh.get_coordinate() is not None
        self.dtensor_mesh = None
        if self.contains_me:
            self.dtensor_mesh = (device_mesh if self.dtensor_axes
                                 == self.axis_names
                                 else device_mesh[self.dtensor_axes])

    @property
    def size(self) -> int:
        return int(self.device_mesh.size())

    def get_group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def axis_index(self, axis: str) -> int:
        return int(self.device_mesh.get_local_rank(axis))

    def placements(self, spec) -> tuple:
        """DTensor placements on `dtensor_mesh` for a spec (a
        PartitionSpec, tuple or None)."""
        from torch.distributed.tensor import Replicate, Shard

        spec = tuple(spec or ())
        out = []
        for axis in self.dtensor_axes:
            dims = [i for i, a in enumerate(spec)
                    if a == axis or (isinstance(a, tuple) and axis in a)]
            if len(dims) > 1:
                raise ValueError(f"spec {spec} names axis {axis!r} twice")
            out.append(Shard(dims[0]) if dims else Replicate())
        for a in spec:
            if isinstance(a, tuple) and [x for x in self.axis_names
                                         if x in a] != list(a):
                raise ValueError(f"a dim split over {a} must list the axes "
                                 f"in mesh order {self.axis_names}")
        return tuple(out)

    def __enter__(self):
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.pop()

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device})"


def current_mesh() -> Mesh:
    """The innermost `with mesh:` block's mesh."""
    if not _CURRENT:
        raise RuntimeError("no mesh is active: pass mesh= or run inside "
                           "`with mesh:`")
    return _CURRENT[-1]


class NamedSharding(NamedTuple):
    """A placement on a mesh: JAX's NamedSharding(mesh, spec)."""
    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return self.mesh.placements(self.spec)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None, *, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of the given shape and axis names over `ranks` (default:
    every rank of the default process group; one is started at world
    size 1 when none exists), rank ranks[i] at row-major position i.
    Every rank of the job calls it, those left out too. device None ->
    cuda (raises without a card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from paddle_tpu_torch.parallel import distributed

    dev = resolve_device(device)
    distributed.ensure_initialized(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    _register_kernel_sharding()
    ranks = (list(range(dist.get_world_size())) if ranks is None
             else list(ranks))
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(f"mesh {shape} != {len(ranks)} ranks")
    dm = DeviceMesh(dev.type, torch.tensor(ranks).reshape(shape),
                    mesh_dim_names=tuple(axis_names))
    return Mesh(dm, dev)


def build_mesh(config: MeshConfig = MeshConfig(), device=None, *,
               ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The (data, model, seq) mesh over `ranks` (default: every rank;
    JAX's `devices=`)."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import distributed

    dev = resolve_device(device)
    distributed.ensure_initialized(dev)
    n = dist.get_world_size() if ranks is None else len(ranks)
    return make_mesh(config.resolve(n), (DATA_AXIS, MODEL_AXIS, SEQ_AXIS),
                     dev, ranks=ranks)


def local_mesh(device=None) -> Mesh:
    """Mesh over all ranks, pure data parallel."""
    return build_mesh(MeshConfig(), device)


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def distribute(x, sharding: NamedSharding):
    """Place x as `sharding` says: a DTensor is redistributed; a plain
    tensor is the full value, the same on every rank (as a host array
    handed to JAX's device_put), and each rank keeps its own slice
    without any communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = sharding.mesh
    placements = sharding.placements
    if isinstance(x, DTensor):
        return x.redistribute(mesh.dtensor_mesh, placements)
    for p, axis in zip(placements, mesh.dtensor_axes):
        if p.is_shard() and x.shape[p.dim] % mesh.shape[axis]:
            raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does not "
                             f"divide over {axis!r} ({mesh.shape[axis]})")
    return distribute_tensor(x.detach().to(mesh.device), mesh.dtensor_mesh,
                             placements, src_data_rank=None)


def with_sharding(x, mesh: Mesh, spec):
    """Redistribute x to `spec` on the mesh (JAX's sharding constraint)."""
    return distribute(x, NamedSharding(mesh, PartitionSpec(*(spec or ()))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over the data axis (per-batch tensors)."""
    return NamedSharding(mesh, P(DATA_AXIS))


def gather_full(x):
    """A DTensor's full value (a plain tensor, the same on every rank of
    its mesh) by synchronous `torch.distributed` collectives: an
    all-gather over each mesh dim it is split on (innermost first, so
    the blocks concatenate in row-major mesh order) and an all-reduce
    over each it is partial on. DTensor's own `full_tensor` runs its
    functional collectives, which gloo on CUDA tensors does not survive
    (a SIGSEGV in a gloo thread, torch 2.11); uneven splits take it all
    the same. A plain tensor comes back as it is."""
    if not hasattr(x, "to_local"):
        return x
    import torch.distributed as dist
    from torch.distributed.tensor import Partial

    mesh, shape = x.device_mesh, x.shape
    local = x.to_local()
    for i, p in reversed(list(enumerate(x.placements))):
        n = mesh.size(i)
        if n == 1:
            continue
        group = mesh.get_group(i)
        if isinstance(p, Partial):
            local = local.clone()
            dist.all_reduce(local, group=group)
        elif p.is_shard():
            d = p.dim
            if shape[d] % n:
                return x.full_tensor()
            moved = local.movedim(d, 0).contiguous()
            out = moved.new_empty((moved.shape[0] * n,)
                                  + tuple(moved.shape[1:]))
            dist.all_gather_into_tensor(out, moved, group=group)
            local = out.movedim(0, d)
    return local


# -- per-rank rows under data parallelism ----------------------------------
# An op whose rows are independent (a convolution, a pool, an embedding
# lookup) runs on each rank's own rows of a batch-split DTensor: no rank
# needs another's rows, and torch 2.11's DTensor lacks or mishandles
# those ops' sharding strategies for a batch split (its convolution
# exchanges width halos whenever it pads; max_pool2d_with_indices and a
# batch-split index_put have none).


def split_rows(x) -> bool:
    """x is a DTensor split over its batch dim only, or replicated."""
    if not hasattr(x, "placements"):
        return False
    from torch.distributed.tensor import Replicate, Shard

    return all(p in (Shard(0), Replicate()) for p in x.placements)


def is_replicated(w) -> bool:
    """w is a DTensor replicated on every mesh dim."""
    from torch.distributed.tensor import Replicate

    return hasattr(w, "placements") and all(p == Replicate()
                                            for p in w.placements)


def rows_weight(w, x):
    """The local value of a replicated DTensor weight used on x's
    rows: its gradient is each rank's partial sum over its rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return w.to_local(grad_placements=[
        Partial() if p == Shard(0) else Replicate() for p in x.placements])


def as_rows(y, like):
    """y, an op's output on `like`'s local rows, as a DTensor placed as
    `like`: its global batch, y's other dims and memory format."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size((like.shape[0],) + tuple(y.shape[1:]))
    fmt = (torch.channels_last if y.dim() == 4 and not y.is_contiguous()
           and y.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    stride = torch.empty(shape, device="meta", memory_format=fmt).stride()
    return DTensor.from_local(y, like.device_mesh, like.placements,
                              run_check=False, shape=shape, stride=stride)


_KERNEL_RULES = []


def _register_kernel_sharding() -> None:
    """The kernels' DTensor sharding rules (registered once).

    Kernel A: batch or heads split alike on q, k, v and o (lse
    [B, H, Tq] follows: dim 0 or 1), the sequence and head_dim never;
    lens [B] follows the batch split. The operator then runs on each
    rank's local shards (kernel A on CUDA tensors), and its backward
    does too (`ops.flash_attention._local_backward`).

    Kernels B and C (the ragged walk over float arenas, and over
    (s8, scale) arenas): all replicated, or the heads split alike on q
    [R, Tq, H, Dh], the arenas [P, page, Hkv, Dh] (C's scale planes
    [P, page, Hkv] too) and the output, with the page table, positions
    and active flags replicated. Each rank then walks its own heads
    (kernel B or C on CUDA tensors). `ops.ragged_paged_attention`
    refuses any other placement before the operator."""
    if _KERNEL_RULES:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    from paddle_tpu_torch.ops import flash_attention  # noqa: F401 (the op)

    @register_sharding(torch.ops.paddle_tpu_torch.flash_fwd.default)
    def _flash_rule(q, k, v, lens, causal, window, block_k):
        r = Replicate()
        statics = [None, None, None]
        return [
            ([r, r], [r, r, r, r] + statics),
            ([Shard(0), Shard(0)], [Shard(0)] * 4 + statics),
            ([Shard(2), Shard(1)], [Shard(2)] * 3 + [r] + statics),
        ]

    from paddle_tpu_torch.ops import ragged_paged_attention  # noqa: F401

    @register_sharding(torch.ops.paddle_tpu_torch.ragged_walk.default)
    def _walk_rule(q, k_arena, v_arena, page_table, pos0, active,
                   page_size, max_len):
        r, h = Replicate(), Shard(2)
        return [([r], [r] * 6 + [None, None]),
                ([h], [h, h, h, r, r, r, None, None])]

    @register_sharding(torch.ops.paddle_tpu_torch.ragged_walk_int8.default)
    def _walk_int8_rule(q, k_data, k_scale, v_data, v_scale, page_table,
                        pos0, active, page_size, max_len):
        r, h = Replicate(), Shard(2)
        return [([r], [r] * 8 + [None, None]),
                ([h], [h] * 5 + [r, r, r, None, None])]

    _KERNEL_RULES.extend([_flash_rule, _walk_rule, _walk_int8_rule])
