"""Sharded and ZeRO train steps (port of `paddle_tpu.parallel.train_step`).

Two halves, as in the JAX package:

- `make_sharded_train_step`: the single-device step body
  (`train.trainer.make_train_step`) run on DTensors. The state is
  placed by `shard_train_state` (parameters by name rules, moments with
  their parameter or ZeRO-sliced, statistics and the step replicated),
  the inputs arrive batch-sharded over `data`, and DTensor's operators
  insert the collectives (JAX: GSPMD). The updated state is
  redistributed to the canonical placements (`constrain_state_fn`, JAX's
  sharding constraint). Plain tensors the body makes (masks, aranges,
  the learning rate) count as replicated (`implicit_replication`).
- `make_zero_train_step`: the explicit ZeRO step (arXiv 2004.13336):
  each rank's forward and backward on its own rows, a reduce-scatter of
  the flat, zero-padded mean gradient, the optimizer update on the
  rank's 1/N slice only, and an all-gather of the new parameters.
  Optimizer state is kept flat and padded, as JAX keeps it, so any
  parameter shape shards evenly and a checkpoint reshards N -> M by
  re-padding (`reshard_zero_leaf`).

Sharded state is DTensors on the mesh's `dtensor_mesh`: rank r's local
shard of a leaf is JAX device r's addressable shard.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.core.mesh import (DATA_AXIS, Mesh, NamedSharding, P,
                                        distribute)
from paddle_tpu_torch.core.pytree import (tree_leaves, tree_map,
                                          tree_map_multi)
from paddle_tpu_torch.nn.composite import Remat
from paddle_tpu_torch.nn.module import Layer, merge_state
from paddle_tpu_torch.optim.optimizers import Optimizer
from paddle_tpu_torch.parallel import collectives as C
from paddle_tpu_torch.parallel import sharding as shard_lib
from paddle_tpu_torch.train.state import TrainState
from paddle_tpu_torch.train.trainer import loss_and_grads, make_train_step


def _structure(tree):
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return ("seq", tuple(_structure(v) for v in tree))
    return None


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _align_opt_shardings(opt_state, params, param_shardings, mesh: Mesh):
    """Give each optimizer-state leaf its parameter's sharding: every
    top-level entry of a dict state that matches params' structure gets
    the param shardings; anything else (scalars, counts) is
    replicated."""
    params_def = _structure(params)
    repl = shard_lib.replicated(mesh)

    def align(node):
        if _structure(node) == params_def:
            return param_shardings
        return tree_map(lambda _: repl, node)

    if isinstance(opt_state, dict):
        return {k: align(v) for k, v in opt_state.items()}
    return tree_map(lambda _: repl, opt_state)


def _place_state(state: TrainState, sh: TrainState) -> TrainState:
    return TrainState(*(shard_lib.place(x, s) for x, s in zip(state, sh)))


def shard_train_state(state: TrainState, mesh: Mesh,
                      param_rules: Optional[Sequence[shard_lib.Rule]] = None,
                      zero: bool = False) -> TrainState:
    """Place an existing TrainState (full tensors, the same on every
    rank) onto the mesh as DTensors. zero=False: optimizer moments take
    their parameter's sharding; zero=True: they are sliced over the data
    axis (`zero_shardings`)."""
    return _place_state(state, train_state_shardings(state, mesh,
                                                     param_rules, zero))


def train_state_shardings(state: TrainState, mesh: Mesh,
                          param_rules: Optional[Sequence[shard_lib.Rule]] = None,
                          zero: bool = False) -> TrainState:
    """The canonical sharding tree for a TrainState on this mesh: params
    via name-pattern rules, model statistics and the step counter
    replicated, optimizer moments params-aligned (or ZeRO data-sliced)."""
    param_sh = shard_lib.make_param_shardings(state.params, mesh, param_rules)
    repl = shard_lib.replicated(mesh)
    mstate_sh = tree_map(lambda _: repl, state.model_state)
    if zero:
        opt_sh = shard_lib.zero_shardings(state.opt_state, mesh)
    else:
        opt_sh = _align_opt_shardings(state.opt_state, state.params,
                                      param_sh, mesh)
    return TrainState(param_sh, mstate_sh, opt_sh, repl)


def _shard_batch(x, mesh: Mesh):
    """A batch leaf split over `data` on dim 0: a DTensor is
    redistributed; a plain tensor is the global batch, the same on every
    rank, and each rank keeps its own rows."""
    if not isinstance(x, torch.Tensor):
        return x
    return distribute(x, shard_lib.batch_sharding(mesh))


def _full(x):
    return x.full_tensor() if _is_dtensor(x) else x


def make_sharded_train_step(
    model: Layer,
    loss_fn: Callable,
    optimizer: Optimizer,
    mesh: Mesh,
    *,
    metrics_fn: Optional[Callable] = None,
    donate: bool = True,
    remat: bool = False,
    param_rules: Optional[Sequence[shard_lib.Rule]] = None,
    zero: bool = False,
    accum_steps: int = 1,
):
    """Train step whose inputs arrive batch-sharded over `data`: (state,
    rng, inputs, labels) -> (new_state, loss, metrics), with `state`
    from `shard_train_state` (the same param_rules and zero).

    The step body is the single-device one (make_train_step) on DTensor
    operands; parallelism comes from the placements. The updated state
    is pinned to the canonical placements. Works for pure DP, DP x TP
    (param_rules shard weights over `model`), ZeRO placement (zero=True)
    and SP meshes. accum_steps > 1 splits the global batch into
    microbatches with ONE update. Plain input tensors are the global
    batch, split over `data` here. loss and metrics come back as plain
    tensors, the same on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    def constrain(new_state: TrainState) -> TrainState:
        sh = train_state_shardings(new_state, mesh, param_rules, zero)
        return _place_state(new_state, sh)

    inner = make_train_step(
        model, loss_fn, optimizer, metrics_fn=metrics_fn, donate=donate,
        remat=remat, accum_steps=accum_steps, constrain_state_fn=constrain)

    def step(state: TrainState, rng, inputs, labels):
        inputs = inputs if isinstance(inputs, tuple) else (inputs,)
        labels = labels if isinstance(labels, tuple) else (labels,)
        inputs = tuple(_shard_batch(x, mesh) for x in inputs)
        labels = tuple(_shard_batch(x, mesh) for x in labels)
        with implicit_replication():
            new_state, loss, metrics = inner(state, rng, inputs, labels)
            return (new_state, _full(loss),
                    {k: _full(v) for k, v in metrics.items()})

    return step


def aot_compile_train_step(step, state, rng, inputs, labels):
    """The step, ready to run, WITHOUT running it. JAX lowers and
    compiles the program here so a restarted trainer reaches its first
    step compile-free; an eager step has no program to compile, and what
    the first call would otherwise build are the kernels' CUDA sources
    (`ops._cuda`, built once per source hash). They are built here when
    the state lives on the card; the example arguments are otherwise
    only templates. Returns `step` itself."""
    leaves = [x for x in tree_leaves(state.params)
              if isinstance(x, torch.Tensor)]
    if any(x.is_cuda for x in leaves):
        from paddle_tpu_torch.ops import _cuda

        _cuda.build_all()
    return step


# ---------------------------------------------------------------------------
# ZeRO: the explicit cross-replica sharding of the weight update.
# ---------------------------------------------------------------------------


def zero_pad(size: int, shards: int) -> int:
    """Length of a `size`-element buffer once zero-padded to shard evenly
    over `shards` replicas."""
    return size + (-size) % shards


def _flatten_pad(x, shards: int):
    flat = x.reshape(-1)
    extra = (-flat.shape[0]) % shards
    if extra:
        flat = torch.cat([flat, flat.new_zeros(extra)])
    return flat


def zero_leaf_spec(leaf, shards: int) -> P:
    """PartitionSpec of one ZeRO-layout optimizer-state leaf: flat
    buffers shard over `data` on axis 0, scalars (and anything that
    cannot split evenly) replicate."""
    shape = tuple(getattr(leaf, "shape", ()))
    if shape and shape[0] and shape[0] % shards == 0:
        return P(DATA_AXIS)
    return P()


def zero_opt_shardings(opt_state, mesh: Mesh):
    n = int(mesh.shape[DATA_AXIS])
    return tree_map(lambda x: NamedSharding(mesh, zero_leaf_spec(x, n)),
                    opt_state)


def zero_init_opt_state(optimizer, params, mesh: Mesh):
    """Optimizer state in the ZeRO layout: `optimizer.init` on the
    flattened, padded view of every parameter (full tensors, the same on
    every rank), each buffer then sliced over the data axis: each rank
    holds ~1/N of the optimizer state, and `make_zero_train_step`
    updates only that slice."""
    n = int(mesh.shape[DATA_AXIS])
    with torch.no_grad():
        opt = optimizer.init(tree_map(
            lambda x: _flatten_pad(_full(x), n), params))
    return shard_lib.place(opt, zero_opt_shardings(opt, mesh))


def zero_state_shardings(state: TrainState, mesh: Mesh) -> TrainState:
    """Canonical shardings of a ZeRO-layout TrainState: params, model
    statistics and the step counter replicated; flat optimizer moments
    sharded over `data`."""
    repl = shard_lib.replicated(mesh)
    return TrainState(
        params=tree_map(lambda _: repl, state.params),
        model_state=tree_map(lambda _: repl, state.model_state),
        opt_state=zero_opt_shardings(state.opt_state, mesh),
        step=repl,
    )


def zero_true_sizes(params, opt_state):
    """Unpadded element count of every ZeRO optimizer-state leaf, in the
    leaf's own tree position: moment trees that structurally match
    `params` carry their parameter's true size; anything else carries
    its own."""
    params_def = _structure(params)
    sizes = tree_map(lambda p: int(np.prod(tuple(p.shape))), params)

    def align(node):
        if _structure(node) == params_def:
            return sizes
        return tree_map(lambda x: int(np.prod(tuple(x.shape))), node)

    if isinstance(opt_state, dict):
        return {k: align(v) for k, v in opt_state.items()}
    return tree_map(lambda x: int(np.prod(tuple(x.shape))), opt_state)


def reshard_zero_leaf(full, true_size: int, mesh: Mesh):
    """Re-pad one saved flat optimizer-state buffer (padded for its OLD
    data-axis size) for THIS mesh and place it sharded over `data`.
    `full` is the fully gathered saved value (a numpy array or a
    tensor)."""
    m = int(mesh.shape[DATA_AXIS])
    flat = torch.as_tensor(np.asarray(full) if not isinstance(
        full, torch.Tensor) else full).reshape(-1)[:true_size]
    out = flat.new_zeros((zero_pad(true_size, m),))
    out[:true_size] = flat
    return distribute(out, NamedSharding(mesh, P(DATA_AXIS)))


def opt_state_bytes_per_replica(opt_state) -> int:
    """Worst-case optimizer-state bytes RESIDENT on one rank -- the
    quantity ZeRO shrinks ~1/N: each rank's local shards summed, the
    largest over the ranks of the state's mesh (a max-reduce over each
    of its dims; every rank of that mesh calls this)."""
    mine, mesh, device = 0, None, None
    for leaf in tree_leaves(opt_state):
        if isinstance(leaf, torch.Tensor):
            local = leaf.to_local() if _is_dtensor(leaf) else leaf
            mine += local.numel() * local.element_size()
            if _is_dtensor(leaf):
                mesh, device = leaf.device_mesh, local.device
    if mesh is None or mesh.size() == 1:
        return mine
    worst = mine
    for dim in range(mesh.ndim):
        group = mesh.get_group(dim)
        # a host count: gloo reduces it on the CPU, NCCL on the card (a
        # group of a cuda mesh over gloo may name its backend
        # "cuda:gloo")
        on = "cpu" if "gloo" in str(dist.get_backend(group)) else device
        t = torch.tensor([worst], dtype=torch.int64, device=on)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        worst = int(t.item())
    return worst


def _local(x):
    return x.to_local() if _is_dtensor(x) else x


def make_zero_train_step(
    model: Layer,
    loss_fn: Callable,
    optimizer: Optimizer,
    mesh: Mesh,
    *,
    metrics_fn: Optional[Callable] = None,
    donate: bool = True,
    remat: bool = False,
    zero_update: bool = True,
    aux_loss_weight: float = 0.0,
):
    """ZeRO train step over a pure data-parallel mesh: (state, rng,
    inputs, labels) -> (new_state, loss, metrics).

    Forward and backward run on each rank's rows; the gradient
    all-reduce is replaced by a reduce-scatter of the flat, padded
    global-MEAN gradient; the optimizer update runs ONLY on the rank's
    1/N slice of params and moments; the updated params are
    all-gathered. zero_update=False is the bit-exactness oracle arm: the
    same reduce-scatter, then the whole reduced gradient all-gathered and
    the whole flat update run on every rank (the moments gathered for
    it and sliced back after). The optimizers' updates are elementwise
    over the flat layout, so the arms are bit-identical (use the
    elementwise family: L-BFGS's dot products or a global-norm clip
    would see per-slice values under zero_update=True).

    state: `TrainState.create_zero` (params replicated, moments in the
    ZeRO layout). Inputs and labels: the global batch (plain tensors,
    the same on every rank, or batch-sharded DTensors); the batch must
    divide the data-axis size. loss and metrics are the means over all
    ranks, as plain tensors. donate=True updates the parameters and
    moments in place."""
    n = int(mesh.shape[DATA_AXIS])
    for ax, size in mesh.shape.items():
        if ax != DATA_AXIS and size != 1:
            raise ValueError(
                f"make_zero_train_step is data-parallel only, but mesh "
                f"axis {ax!r} has size {size}; use make_sharded_train_step"
                f"(zero=True) for DP×TP meshes")
    applied = Remat(model, policy=None) if remat else model

    def pmean_floats(tree):
        return tree_map(
            lambda x: C.all_reduce_mean(x, DATA_AXIS, mesh=mesh)
            if isinstance(x, torch.Tensor) and x.is_floating_point() else x,
            tree)

    def rows(x):
        if not isinstance(x, torch.Tensor):
            return x
        return _local(_shard_batch(x, mesh))

    def step(state: TrainState, rng, inputs, labels):
        inputs = inputs if isinstance(inputs, tuple) else (inputs,)
        labels = labels if isinstance(labels, tuple) else (labels,)
        idx = mesh.axis_index(DATA_AXIS)
        params = tree_map(_local, state.params)
        mstate = tree_map(_local, state.model_state)
        step_ct = _local(state.step)
        loss, new_mstate, grads, metrics = loss_and_grads(
            applied, loss_fn, params, mstate, rng,
            tuple(rows(x) for x in inputs), tuple(rows(x) for x in labels),
            metrics_fn=metrics_fn, aux_loss_weight=aux_loss_weight)
        with torch.no_grad():
            # reduce-scatter of the global-MEAN gradient: each rank keeps
            # its own contiguous 1/n slice of every flat, padded gradient
            gshard = tree_map(
                lambda g: C._raw_reduce_scatter(
                    _flatten_pad(g, n), mesh, DATA_AXIS, 0) / n, grads)
            if zero_update:
                opt = tree_map(_local, state.opt_state)
                if not donate:
                    opt = tree_map(torch.clone, opt)
                pshard = tree_map(
                    lambda p: _flatten_pad(p, n).chunk(n)[idx].clone(),
                    params)
                new_pshard, opt = optimizer.update(gshard, opt, pshard,
                                                   step_ct)
                pfull = tree_map(lambda s: C._raw_all_gather(
                    s, mesh, DATA_AXIS, 0), new_pshard)
                new_opt = tree_map_multi(_rewrap, opt, state.opt_state)
            else:
                gfull = tree_map(lambda s: C._raw_all_gather(
                    s, mesh, DATA_AXIS, 0), gshard)
                opt = tree_map(lambda x: _local(
                    distribute(x, shard_lib.replicated(mesh)))
                    if _is_dtensor(x) else x.clone(), state.opt_state)
                pflat = tree_map(lambda p: _flatten_pad(p, n).clone(),
                                 params)
                pfull, opt = optimizer.update(gfull, opt, pflat, step_ct)
                new_opt = tree_map_multi(
                    lambda o, x: _rewrap_full(o, x, mesh), opt,
                    state.opt_state)
            if not donate:
                params = tree_map(torch.clone, params)
            tree_map_multi(lambda p, f: p.copy_(
                f[:p.numel()].reshape(p.shape)), params, pfull)
        new_params = tree_map_multi(_rewrap, params, state.params)
        loss = C._raw_all_reduce(loss, mesh, (DATA_AXIS,)) / n
        metrics = {k: C._raw_all_reduce(v, mesh, (DATA_AXIS,)) / n
                   for k, v in metrics.items()}
        rep = state.step
        new_mstate = tree_map(
            lambda x: _rewrap_full(x, rep, mesh)
            if isinstance(x, torch.Tensor) else x, pmean_floats(new_mstate))
        new_state = TrainState(
            params=new_params,
            model_state=merge_state(state.model_state, new_mstate),
            opt_state=new_opt,
            step=_rewrap(step_ct + 1, state.step),
        )
        return new_state, loss, metrics

    return step


def _rewrap(local, like):
    """`local` as a DTensor placed like `like` (a DTensor), or as it is
    when `like` is a plain tensor."""
    if not _is_dtensor(like):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def _rewrap_full(full, like, mesh: Mesh):
    """A full (replicated) value placed back as `like` is placed."""
    if not _is_dtensor(like):
        return full
    from torch.distributed.tensor import DTensor

    rep = DTensor.from_local(full, like.device_mesh,
                             mesh.placements(P()), run_check=False)
    return rep.redistribute(like.device_mesh, like.placements)

