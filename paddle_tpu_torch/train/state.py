"""TrainState: the complete training state as one tree (port of
`paddle_tpu.train.state.TrainState`: `create`, and `create_zero` for the
ZeRO layout of `parallel.train_step`)."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from paddle_tpu_torch.core.pytree import tree_leaves


class TrainState(NamedTuple):
    params: Any
    model_state: Any  # mutable layer statistics (BN running stats)
    opt_state: Any
    step: torch.Tensor  # int32 0-d, on the parameters' device

    @classmethod
    def create(cls, params, model_state, optimizer):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return cls(
            params=params,
            model_state=model_state,
            opt_state=optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=device),
        )

    @classmethod
    def create_zero(cls, params, model_state, optimizer, mesh):
        """TrainState in the ZeRO layout for `mesh`: params, model state
        and step replicated over the mesh (DTensors), optimizer moments
        flat-padded and sharded over the data axis
        (`parallel.train_step.zero_init_opt_state`) -- the state
        `parallel.make_zero_train_step` takes. params and model_state:
        full tensors, the same on every rank."""
        # local import: parallel.train_step imports this module
        from paddle_tpu_torch.parallel.sharding import place, replicated
        from paddle_tpu_torch.parallel.train_step import zero_init_opt_state
        from paddle_tpu_torch.core.mesh import distribute
        from paddle_tpu_torch.core.pytree import tree_map

        repl = replicated(mesh)
        step = torch.zeros((), dtype=torch.int32, device=mesh.device)
        return cls(
            params=place(params, tree_map(lambda _: repl, params)),
            model_state=place(model_state,
                              tree_map(lambda _: repl, model_state)),
            opt_state=zero_init_opt_state(optimizer, params, mesh),
            step=distribute(step, repl),
        )
