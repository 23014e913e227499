"""Optimizers as gradient transforms (port of
`paddle_tpu.optim.optimizers`: sgd, momentum, adagrad, decayed_adagrad,
adadelta, rmsprop, adam, adamax, ftrl, lbfgs, owlqn, proximal_gd, the
clipping transforms, `chain` and `get`).

Each optimizer is an `Optimizer` with
  init(params) -> opt_state (a tree aligned with params)
  update(grads, opt_state, params, step) -> (params, opt_state)
with the JAX package's formulas, op for op, and its opt_state trees
(`models.weights.opt_state_from_numpy` carries a JAX run's state over).
Where the JAX step donates its state, these update params and opt_state
IN PLACE under `torch.no_grad()` and return the same tensors: no second
copy of the parameters or moments is made. The learning rate comes from
the step tensor on its device, so an update never syncs with the host.

Adam is the reference's, not `torch.optim.Adam`: the step is
`lr*sqrt(1-b2^t)/(1-b1^t) * m/(sqrt(v)+eps)`, eps outside the bias
correction.

L-BFGS and OWL-QN keep flat f32 state over every parameter, in JAX's
flatten order (dict keys sorted): `s` and `y` are [history, total]. The
flat vectors are one `torch.cat`; the new parameters are views of one
flat vector, copied into the leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from paddle_tpu_torch.core.pytree import (flatten_with_keys, tree_map,
                                          tree_map_with_name, tree_zip)
from paddle_tpu_torch.optim import schedules

OptState = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, opt_state, params, step) -> (params, opt_state)

    def with_transforms(self, *, weight_decay: float = 0.0,
                        clip_global_norm: Optional[float] = None,
                        clip_value: Optional[float] = None) -> "Optimizer":
        return chain(self, weight_decay=weight_decay,
                     clip_global_norm=clip_global_norm, clip_value=clip_value)


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _leaves(*trees):
    """The leaves of params-shaped trees side by side, matched by key."""
    return tree_zip(*trees)


def sgd(learning_rate=0.01) -> Optimizer:
    """Plain SGD: p <- p - lr * g."""
    lr_fn = schedules.resolve(learning_rate)

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr = lr_fn(step)
        for p, g in _leaves(params, grads):
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
        for p, g, v in _leaves(params, grads, opt_state["velocity"]):
            v.copy_(mu * v + g.to(v.dtype))
            upd = g + mu * v if nesterov else v
            p.sub_(lr * upd.to(p.dtype))
        return params, opt_state

    return Optimizer(init, update)


def adagrad(learning_rate=0.01, epsilon: float = 1e-6) -> Optimizer:
    """Adagrad: a <- a + g^2; p <- p - lr * g / (sqrt(a) + eps)."""
    lr_fn = schedules.resolve(learning_rate)

    def init(params):
        return {"accum": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr = lr_fn(step)
        for p, g, a in _leaves(params, grads, opt_state["accum"]):
            a.copy_(a + torch.square(g.to(a.dtype)))
            p.sub_(lr * g.to(p.dtype) / (torch.sqrt(a) + epsilon))
        return params, opt_state

    return Optimizer(init, update)


def decayed_adagrad(learning_rate=0.01, decay: float = 0.95,
                    epsilon: float = 1e-6) -> Optimizer:
    """Decayed Adagrad: a <- decay*a + (1-decay)*g^2."""
    lr_fn = schedules.resolve(learning_rate)

    def init(params):
        return {"accum": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr = lr_fn(step)
        for p, g, a in _leaves(params, grads, opt_state["accum"]):
            a.copy_(decay * a + (1.0 - decay) * torch.square(g.to(a.dtype)))
            p.sub_(lr * g.to(p.dtype) / (torch.sqrt(a) + epsilon))
        return params, opt_state

    return Optimizer(init, update)


def adadelta(rho: float = 0.95, epsilon: float = 1e-6,
             learning_rate=1.0) -> Optimizer:
    """AdaDelta: the step is g * sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps),
    E[dx^2] updated after it."""
    lr_fn = schedules.resolve(learning_rate)

    def init(params):
        return {"accum_g": _zeros_like(params),
                "accum_dx": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr = lr_fn(step)
        for p, g, ag, adx in _leaves(params, grads, opt_state["accum_g"],
                                     opt_state["accum_dx"]):
            ag.copy_(rho * ag + (1 - rho) * torch.square(g.to(ag.dtype)))
            delta = (g.to(ag.dtype) * torch.sqrt(adx + epsilon)
                     / torch.sqrt(ag + epsilon))
            adx.copy_(rho * adx + (1 - rho) * torch.square(delta))
            p.sub_(lr * delta.to(p.dtype))
        return params, opt_state

    return Optimizer(init, update)


def rmsprop(learning_rate=0.01, rho: float = 0.95, epsilon: float = 1e-6,
            momentum_mu: float = 0.0) -> Optimizer:
    """RMSProp: ms <- rho*ms + (1-rho)*g^2, the step g / (sqrt(ms) + eps),
    through a momentum buffer when momentum_mu is set."""
    lr_fn = schedules.resolve(learning_rate)

    def init(params):
        st = {"ms": _zeros_like(params)}
        if momentum_mu:
            st["mom"] = _zeros_like(params)
        return st

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr = lr_fn(step)
        moms = opt_state["mom"] if momentum_mu else tree_map(
            lambda _: None, params)
        for p, g, ms, mom in _leaves(params, grads, opt_state["ms"], moms):
            ms.copy_(rho * ms + (1 - rho) * torch.square(g.to(ms.dtype)))
            scaled = g.to(ms.dtype) / (torch.sqrt(ms) + epsilon)
            if momentum_mu:
                mom.copy_(momentum_mu * mom + lr * scaled)
                p.sub_(mom.to(p.dtype))
            else:
                p.sub_(lr * scaled.to(p.dtype))
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
        for p, g, m, v in _leaves(params, grads, opt_state["m"],
                                  opt_state["v"]):
            m.copy_(beta1 * m + (1 - beta1) * g.to(m.dtype))
            v.copy_(beta2 * v + (1 - beta2) * torch.square(g.to(v.dtype)))
            p.sub_((lr * m / (torch.sqrt(v) + epsilon)).to(p.dtype))
        return params, opt_state

    return Optimizer(init, update)


def adamax(learning_rate=0.002, beta1: float = 0.9, beta2: float = 0.999,
           epsilon: float = 1e-8) -> Optimizer:
    """Adamax: u <- max(beta2*u, |g|); p <- p - lr/(1-b1^t) * m/(u+eps)."""
    lr_fn = schedules.resolve(learning_rate)

    def init(params):
        return {"m": _zeros_like(params), "u": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        t = step.to(torch.float32) + 1.0
        lr = lr_fn(step) / (1.0 - beta1 ** t)
        for p, g, m, u in _leaves(params, grads, opt_state["m"],
                                  opt_state["u"]):
            m.copy_(beta1 * m + (1 - beta1) * g.to(m.dtype))
            u.copy_(torch.maximum(beta2 * u, torch.abs(g.to(u.dtype))))
            p.sub_((lr * m / (u + epsilon)).to(p.dtype))
        return params, opt_state

    return Optimizer(init, update)


def ftrl(learning_rate=0.01, l1: float = 0.0, l2: float = 0.0,
         lr_power: float = -0.5) -> Optimizer:
    """FTRL-proximal: the parameters are solved from the accumulators
    (n, z) each step."""
    lr_fn = schedules.resolve(learning_rate)

    def init(params):
        return {"n": _zeros_like(params), "z": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr = lr_fn(step)
        for p, g, n, z in _leaves(params, grads, opt_state["n"],
                                  opt_state["z"]):
            g = g.to(p.dtype)
            new_n = n + torch.square(g)
            sigma = (torch.pow(new_n, -lr_power)
                     - torch.pow(n, -lr_power)) / lr
            z.copy_(z + g - sigma * p)
            n.copy_(new_n)
            p.copy_(torch.where(
                torch.abs(z) <= l1, torch.zeros_like(p),
                (torch.sign(z) * l1 - z)
                / (torch.pow(new_n, -lr_power) / lr + 2 * l2)))
        return params, opt_state

    return Optimizer(init, update)


def _flat(leaves) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])


def _lbfgs_family(learning_rate, history: int, min_curvature: float,
                  l1: float) -> Optimizer:
    """Shared L-BFGS / OWL-QN core (see lbfgs() and owlqn())."""
    lr_fn = schedules.resolve(learning_rate)
    m = history

    def init(params):
        leaves = [leaf for _, leaf in flatten_with_keys(params)]
        total = sum(t.numel() for t in leaves)
        dev = leaves[0].device if leaves else None
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        return {
            "s": z(m, total),
            "y": z(m, total),
            "rho": z(m),              # 1/(s.y); 0 = an empty slot
            "prev_x": z(total),
            "prev_g": z(total),
            "gamma": torch.ones((), dtype=torch.float32, device=dev),
            "count": torch.zeros((), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr = lr_fn(step)
        p_leaves = [leaf for _, leaf in flatten_with_keys(params)]
        x = _flat(p_leaves)
        g = _flat(leaf for _, leaf in flatten_with_keys(grads))
        if l1 > 0.0:
            # the L1 pseudo-gradient: the subgradient pointing into the
            # descent orthant; coordinates at 0 inside [-l1, l1] get 0
            pg = torch.where(
                x < 0, g - l1,
                torch.where(x > 0, g + l1,
                            torch.where(g < -l1, g + l1,
                                        torch.where(g > l1, g - l1,
                                                    torch.zeros_like(g)))))
        else:
            pg = g
        st = opt_state
        count = st["count"]
        s_buf, y_buf, rho = st["s"], st["y"], st["rho"]

        # record the newest (s, y) pair from the PREVIOUS step
        s_new = x - st["prev_x"]
        y_new = g - st["prev_g"]
        sy = torch.dot(s_new, y_new)
        started = count > 0
        ok = started & (sy > min_curvature)
        slot = torch.where(started, torch.remainder(count - 1, m),
                           torch.zeros_like(count)).long().reshape(1)
        s_buf.index_copy_(0, slot, torch.where(ok, s_new, s_buf[slot][0])[None])
        y_buf.index_copy_(0, slot, torch.where(ok, y_new, y_buf[slot][0])[None])
        # a rejected pair INVALIDATES the slot (rho 0)
        rho.index_copy_(0, slot, torch.where(
            ok, 1.0 / torch.clamp(sy, min=min_curvature),
            torch.zeros_like(sy)).reshape(1))

        # two-loop recursion, newest -> oldest then back; empty slots
        # carry rho == 0 so their terms vanish
        q = pg
        alphas = []
        for i in range(m):
            j = torch.remainder(slot - i, m)
            a = rho[j][0] * torch.dot(s_buf[j][0], q)
            q = q - a * y_buf[j][0]
            alphas.append((j, a))
        # initial Hessian scale s.y / y.y of the newest ACCEPTED pair
        ynorm = torch.dot(y_new, y_new)
        gamma = torch.where(ok, sy / torch.clamp(ynorm, min=1e-12),
                            st["gamma"])
        r = gamma * q
        for j, a in reversed(alphas):
            b = rho[j][0] * torch.dot(y_buf[j][0], r)
            r = r + (a - b) * s_buf[j][0]

        # first step (no history): the plain (pseudo-)gradient direction
        direction = torch.where(started, r, pg)
        if l1 > 0.0:
            # the direction may not leave the steepest-descent orthant
            direction = torch.where(direction * pg > 0, direction,
                                    torch.zeros_like(direction))
        new_x = x - lr * direction
        if l1 > 0.0:
            # a coordinate crossing zero clamps AT zero
            new_x = torch.where(x * new_x < 0, torch.zeros_like(new_x),
                                new_x)
        st["prev_x"].copy_(x)
        st["prev_g"].copy_(g)
        st["gamma"].copy_(gamma)
        count.add_(1)
        views = torch.split(new_x, [p.numel() for p in p_leaves])
        for p, v in zip(p_leaves, views):
            p.copy_(v.view(p.shape))
        return params, opt_state

    return Optimizer(init, update)


def lbfgs(learning_rate=1.0, history: int = 10,
          min_curvature: float = 1e-10) -> Optimizer:
    """Limited-memory BFGS with the two-loop recursion over a fixed
    history of `history` (s, y) pairs in a rolling buffer; a pair with
    curvature s.y <= min_curvature invalidates its slot. No line search:
    the step is `learning_rate * H^-1 g`; the first step is plain
    gradient descent."""
    return _lbfgs_family(learning_rate, history, min_curvature, 0.0)


def owlqn(learning_rate=1.0, l1: float = 1e-4, history: int = 10,
          min_curvature: float = 1e-10) -> Optimizer:
    """Orthant-wise L-BFGS for f(x) + l1*|x|_1 (OWL-QN): the L1
    pseudo-gradient, the direction held to the descent orthant and the
    orthant projection that gives exact zeros."""
    if l1 <= 0:
        raise ValueError(f"owlqn requires l1 > 0, got {l1}")
    return _lbfgs_family(learning_rate, history, min_curvature, l1)


def proximal_gd(learning_rate=0.01, l1: float = 0.0,
                l2: float = 0.0) -> Optimizer:
    """Proximal gradient descent: a gradient step, then the L1/L2
    proximal map."""
    lr_fn = schedules.resolve(learning_rate)

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr = lr_fn(step)
        for p, g in _leaves(params, grads):
            prox = p - lr * g.to(p.dtype)
            p.copy_(torch.sign(prox)
                    * torch.clamp(torch.abs(prox) - lr * l1, min=0.0)
                    / (1.0 + lr * l2))
        return params, opt_state

    return Optimizer(init, update)


# -- transforms: clipping, weight decay, composition ---------------------------


def global_norm(tree) -> torch.Tensor:
    """L2 norm over all leaves, in f32, summed in JAX's flatten order."""
    leaves = [torch.sum(torch.square(x.float()))
              for _, x in flatten_with_keys(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(grads, max_norm: float):
    """Global-norm gradient clipping: (grads * min(1, max_norm / norm),
    norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def clip_by_value(grads, limit: float):
    return tree_map(lambda g: torch.clamp(g, -limit, limit), grads)


def chain(base: Optimizer, *, weight_decay: float = 0.0,
          clip_global_norm: Optional[float] = None,
          clip_value: Optional[float] = None,
          decay_mask: Optional[Callable[[str], bool]] = None) -> Optimizer:
    """Wrap an optimizer with gradient clipping (by value, then by global
    norm) and L2 weight decay (g + wd * p), the decay limited to the
    parameters whose "/"-joined name `decay_mask` accepts."""

    def update(grads, opt_state, params, step):
        if clip_value is not None:
            grads = clip_by_value(grads, clip_value)
        if clip_global_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_global_norm)
        if weight_decay:
            named = {}
            tree_map_with_name(named.__setitem__, params)
            grads = tree_map_with_name(
                lambda name, g: (g + weight_decay * named[name].to(g.dtype)
                                 if decay_mask is None or decay_mask(name)
                                 else g),
                grads)
        return base.update(grads, opt_state, params, step)

    return Optimizer(base.init, update)


def get(name: str, **kwargs) -> Optimizer:
    table = {
        "sgd": sgd,
        "momentum": momentum,
        "adagrad": adagrad,
        "decayed_adagrad": decayed_adagrad,
        "adadelta": adadelta,
        "rmsprop": rmsprop,
        "adam": adam,
        "adamax": adamax,
        "ftrl": ftrl,
        "lbfgs": lbfgs,
        "owlqn": owlqn,
        "proximal_gd": proximal_gd,
    }
    try:
        return table[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(table)}") from None
