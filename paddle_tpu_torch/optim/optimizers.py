"""Optimizers as gradient transforms (port of `sgd`, `momentum`, `adam`
and `clip_by_global_norm` of `paddle_tpu.optim.optimizers`).

Each optimizer is an `Optimizer` with
  init(params) -> opt_state (a tree aligned with params)
  update(grads, opt_state, params, step) -> (params, opt_state)
with the JAX package's formulas, op for op. Where the JAX step donates
its state, these update params and opt_state IN PLACE under
`torch.no_grad()` and return the same tensors: no second copy of the
parameters or moments is made. The learning rate comes from the step
tensor on its device, so an update never syncs with the host.

Adam is the reference's, not `torch.optim.Adam`: the step is
`lr*sqrt(1-b2^t)/(1-b1^t) * m/(sqrt(v)+eps)`, eps outside the bias
correction. The other optimizers of the JAX package (adagrad, adadelta,
rmsprop, adamax, ftrl, the L-BFGS family, proximal, `chain`) are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
from paddle_tpu_torch.optim import schedules

OptState = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, opt_state, params, step) -> (params, opt_state)


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def sgd(learning_rate=0.01) -> Optimizer:
    """Plain SGD: p <- p - lr * g."""
    lr_fn = schedules.resolve(learning_rate)

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr = lr_fn(step)
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.sub_(lr * g.to(p.dtype))
        return params, opt_state

    return Optimizer(init, update)


def momentum(learning_rate=0.01, mu: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    """Momentum SGD: v <- mu*v + g; p <- p - lr * (v, or g + mu*v with
    nesterov)."""
    lr_fn = schedules.resolve(learning_rate)

    def init(params):
        return {"velocity": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr = lr_fn(step)
        for p, g, v in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(opt_state["velocity"])):
            v.copy_(mu * v + g.to(v.dtype))
            upd = g + mu * v if nesterov else v
            p.sub_(lr * upd.to(p.dtype))
        return params, opt_state

    return Optimizer(init, update)


def adam(learning_rate=0.001, beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-8) -> Optimizer:
    """Adam with the reference's bias correction (see the module
    docstring)."""
    lr_fn = schedules.resolve(learning_rate)

    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        t = step.to(torch.float32) + 1.0
        lr = lr_fn(step) * torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(opt_state["m"]),
                              tree_leaves(opt_state["v"])):
            m.copy_(beta1 * m + (1 - beta1) * g.to(m.dtype))
            v.copy_(beta2 * v + (1 - beta2) * torch.square(g.to(v.dtype)))
            p.sub_((lr * m / (torch.sqrt(v) + epsilon)).to(p.dtype))
        return params, opt_state

    return Optimizer(init, update)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over all leaves, in f32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(grads, max_norm: float):
    """Global-norm gradient clipping: (grads * min(1, max_norm / norm),
    norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm
