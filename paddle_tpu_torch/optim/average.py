"""Model averaging (port of `paddle_tpu.optim.average`).

Parity with the reference's AverageOptimizer (a moving-window average of
the parameter values, applied at test or save time): keep `(sum, count)`
beside the params; `averaged_params` returns the averaged values for
evaluation and leaves the training params untouched. The count stays on
the device, so nothing here syncs with the host.
"""

from __future__ import annotations

from typing import Any

import torch

from paddle_tpu_torch.core.pytree import tree_leaves, tree_map, tree_map_multi


def init(params) -> Any:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {
        "sum": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params),
        "count": torch.zeros((), dtype=torch.float32, device=dev),
    }


def accumulate(avg_state, params, *, max_average_window: float = 0.0):
    """Add the current params into the running average.

    With max_average_window > 0 the window restarts from the current
    params once the count exceeds the window."""
    new_sum = tree_map_multi(lambda s, p: s + p.to(torch.float32),
                       avg_state["sum"], params)
    new_count = avg_state["count"] + 1.0
    if max_average_window and max_average_window > 0:
        reset = new_count > max_average_window
        new_sum = tree_map_multi(
            lambda s, p: torch.where(reset, p.to(torch.float32), s),
            new_sum, params)
        new_count = torch.where(reset, torch.ones_like(new_count),
                                new_count)
    return {"sum": new_sum, "count": new_count}


def averaged_params(avg_state, params):
    """The averaged params; the raw params where nothing is accumulated
    yet (count 0)."""
    count = torch.clamp(avg_state["count"], min=1.0)
    has_avg = avg_state["count"] > 0
    return tree_map_multi(
        lambda s, p: torch.where(has_avg, (s / count).to(p.dtype), p),
        avg_state["sum"], params)
