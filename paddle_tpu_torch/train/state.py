"""TrainState: the complete training state as one tree (port of
`paddle_tpu.train.state.TrainState.create`; the ZeRO layout comes with
the distributed port)."""

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
