"""Parameter-update hooks (port of `paddle_tpu.optim.hooks`; reference:
parameter/ParameterUpdaterHook.cpp -- the static pruning hook masks the
parameter values after every update, with masks built from the initial
magnitudes at a given sparsity ratio)."""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from paddle_tpu_torch.core.pytree import tree_map_with_name, tree_zip
from paddle_tpu_torch.optim.optimizers import Optimizer


def magnitude_masks(params: Any, sparsity_ratio: float,
                    match: Optional[Callable[[str], bool]] = None):
    """Per-tensor bool masks keeping the top (1 - ratio) fraction of
    entries by |value|, exactly k = int(size * (1 - ratio)) of them: the
    order is a stable sort of -|value|, so ties keep the lower index, as
    in the JAX package.

    match: optional predicate on the "/"-joined parameter name;
    unmatched tensors get an all-ones mask."""

    def mask(name, leaf):
        if match is not None and not match(name):
            return torch.ones_like(leaf, dtype=torch.bool)
        k = int(leaf.numel() * (1.0 - sparsity_ratio))
        flat = torch.zeros(leaf.numel(), dtype=torch.bool,
                           device=leaf.device)
        if k > 0:
            order = torch.argsort(-torch.abs(leaf).reshape(-1), stable=True)
            flat[order[:k]] = True
        return flat.reshape(leaf.shape)

    return tree_map_with_name(mask, params)


def with_pruning(optimizer: Optimizer, masks: Any) -> Optimizer:
    """Wrap an optimizer so the updated params are masked every step (in
    place, as the port's updates are)."""

    def update(grads, opt_state, params, step):
        new_params, new_opt = optimizer.update(grads, opt_state, params,
                                               step)
        with torch.no_grad():
            for p, m in tree_zip(new_params, masks):
                p.mul_(m.to(p.dtype))
        return new_params, new_opt

    return Optimizer(optimizer.init, update)


def with_update_hook(optimizer: Optimizer,
                     hook: Callable[[Any, Any], Any]) -> Optimizer:
    """General post-update hook: params = hook(params, step)."""

    def update(grads, opt_state, params, step):
        new_params, new_opt = optimizer.update(grads, opt_state, params,
                                               step)
        return hook(new_params, step), new_opt

    return Optimizer(optimizer.init, update)
