"""Pipeline parallelism over a `pipe` mesh axis, GPipe-style (port of
`paddle_tpu.parallel.pipeline`).

S homogeneous stages' parameters live stacked on a leading axis sharded
over `pipe` (each rank holds ONE stage). Microbatches stream through
M + S - 1 ticks; at each tick the activation of the last tick moves one
stage on by a ring shift (`collectives.ppermute_ring`, point-to-point
sends whose backward is the opposite shift), so the backward is
autograd through the same per-rank loop: a GPipe-schedule training step
without hand-written reverse plumbing.

Constraints (those of stacked-stage pipelining): every stage shares one
parameter structure and shape, and the activation shape is constant
across stages.

`tp_axis` (opt-in) adds tensor parallelism inside every stage: the
matrix leaves of the stacked params ([S, K, N]) also split their
contracting dim over that second mesh axis, and stage_fn takes a third
argument `mm(x, w_loc) -> x @ w`, `blocked_matmul.tp_dense` (the
row-parallel dense; `tp_overlap=True` its reduce ring). The stage body
routes every big matmul through `mm`; activations stay replicated over
the tp axis.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from paddle_tpu_torch.core.mesh import Mesh, NamedSharding, P
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map, tree_map_multi
from paddle_tpu_torch.parallel import blocked_matmul
from paddle_tpu_torch.parallel import collectives as C
from paddle_tpu_torch.parallel import sharding as shard_lib

PIPE_AXIS = "pipe"

def stack_stage_params(per_stage_params):
    """Stack a list of S identical-structure param trees into one tree
    with leading dim S (shard it over 'pipe' with shard_stage_params)."""
    return tree_map_multi(lambda *xs: torch.stack(xs), *per_stage_params)


def _stage_spec(x, axis: str, tp_axis: Optional[str]) -> tuple:
    """Spec of one stacked-stage leaf: the stage dim over `axis`; with
    tensor parallelism on, matrix leaves (ndim >= 3: [S, K, N]) also
    split their contracting dim over `tp_axis` (the row-parallel layout
    `blocked_matmul.tp_dense` takes), vectors (biases) stay replicated
    over it."""
    if tp_axis is not None and x.ndim >= 3:
        return (axis, tp_axis) + (None,) * (x.ndim - 2)
    return (axis,) + (None,) * (x.ndim - 1)


def shard_stage_params(stacked, mesh: Mesh, axis: str = PIPE_AXIS,
                       tp_axis: Optional[str] = None):
    """Place the stacked stage params so each pipe rank holds its own
    stage's slice (DTensors sharded on dim 0 over `axis`; with
    `tp_axis`, each tp rank its weight-row block)."""
    return shard_lib.place(stacked, tree_map(
        lambda x: NamedSharding(mesh, P(*_stage_spec(x, axis, tp_axis))),
        stacked))


def make_pipeline_forward(stage_fn: Callable, mesh: Mesh, *,
                          axis: str = PIPE_AXIS,
                          tp_axis: Optional[str] = None,
                          tp_overlap: bool = True):
    """Build fn(stacked_params, micro_x) -> outputs.

    stage_fn(stage_params, x) -> y with y.shape == x.shape. stacked
    params: a tree with leading dim S = |pipe| (DTensors from
    shard_stage_params, or full plain tensors, the same on every rank).
    micro_x: [M, Bm, ...] microbatches, the same on every rank. Returns
    the [M, Bm, ...] outputs, the same on every rank (a plain tensor).

    Schedule: M + S - 1 ticks; at tick t stage 0 ingests microbatch t
    (while t < M), stage s computes on what stage s-1 produced at t-1,
    and the last stage's outputs from ticks S-1 .. S-2+M are the
    results, in microbatch order (zero elsewhere, then summed over the
    axis so every rank holds them)."""
    n_stage = mesh.shape[axis]
    tp_mm = None
    if tp_axis is not None:
        tp_mm = functools.partial(blocked_matmul.tp_dense, axis=tp_axis,
                                  overlap=tp_overlap, mesh=mesh)

    def fwd(stacked_params, micro_x):
        local = tree_map(lambda x: C.shard_local(
            x, _stage_spec(x, axis, tp_axis), mesh=mesh), stacked_params)
        lead = tree_leaves(local)[0].shape[0]
        if lead != 1:
            raise ValueError(
                f"stacked stage params have {lead * n_stage} stages but "
                f"the '{axis}' mesh axis has {n_stage} ranks -- one "
                "stage per rank required")
        params = tree_map(lambda x: x[0], local)
        if hasattr(micro_x, "full_tensor"):
            micro_x = micro_x.full_tensor()
        me = mesh.axis_index(axis)
        # selections by a tensor condition, not by python: every rank
        # records the same graph, so every rank's backward runs the
        # same sends in the same order
        first = torch.tensor(me == 0, device=micro_x.device)
        last = torch.tensor(me == n_stage - 1, device=micro_x.device)
        m = micro_x.shape[0]
        act = torch.zeros_like(micro_x[0])
        outs = []
        for t in range(m + n_stage - 1):
            # the activation produced LAST tick moves one stage right
            inbound = C.ppermute_ring(act, axis, shift=1, mesh=mesh)
            x_in = torch.where(first, micro_x[min(t, m - 1)], inbound)
            act = (stage_fn(params, x_in) if tp_mm is None
                   else stage_fn(params, x_in, tp_mm))
            outs.append(act)
        results = torch.stack(outs[n_stage - 1:n_stage - 1 + m])
        results = torch.where(last, results, torch.zeros_like(results))
        return C.all_reduce_sum(results, axis, mesh=mesh)

    return fwd


def make_pipeline_train_step(stage_fn: Callable, loss_fn: Callable,
                             optimizer, mesh: Mesh, *,
                             axis: str = PIPE_AXIS,
                             tp_axis: Optional[str] = None,
                             tp_overlap: bool = True):
    """Pipeline-parallel training step.

    loss_fn(outputs [M, Bm, ...], labels [M, Bm, ...]) -> scalar.
    Returns step(stacked_params, opt_state, micro_x, micro_y, step_i) ->
    (new_params, new_opt_state, loss): gradients flow through the
    per-rank loop by autograd, and the optimizer updates each stage's
    slice where it lives (stacked params and opt_state as DTensors from
    shard_stage_params and optimizer.init; updated in place)."""
    from torch.distributed.tensor.experimental import implicit_replication

    forward = make_pipeline_forward(stage_fn, mesh, axis=axis,
                                    tp_axis=tp_axis, tp_overlap=tp_overlap)

    def step(stacked_params, opt_state, micro_x, micro_y, step_i):
        leaves = tree_leaves(stacked_params)
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        tracked = tree_map(lambda _: next(it), stacked_params)
        with torch.enable_grad():
            loss = loss_fn(forward(tracked, micro_x), micro_y)
            grads = torch.autograd.grad(loss, live)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), stacked_params)
        with implicit_replication():
            new_params, new_opt = optimizer.update(grads, opt_state,
                                                   stacked_params, step_i)
        return new_params, new_opt, loss.detach()

    return step
