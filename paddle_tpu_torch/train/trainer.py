"""Event-driven trainer (port of `paddle_tpu.train.trainer`:
`make_train_step`, `make_eval_step` and `Trainer`'s init_state / train /
evaluate).

The JAX step is one jitted program; here it runs eagerly: forward,
`torch.autograd.grad` over the parameter tree's leaves (kernels get
their gradients through their `torch.autograd.Function`s), then the
optimizer's in-place update. The loss stays on the device; an
`EndIteration` event reads it only when its handler asks.

Not ported yet: `remat`, `accum_steps > 1`, `constrain_state_fn` and
`aux_loss_weight` (they raise NotImplementedError), `check_gradients`,
evaluators and checkpoints.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
from paddle_tpu_torch.nn.module import Layer, merge_state
from paddle_tpu_torch.optim.optimizers import Optimizer
from paddle_tpu_torch.train import events as E
from paddle_tpu_torch.train.state import TrainState

LossFn = Callable[..., torch.Tensor]

_QUEUE = "ROADMAP queue 1"


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def loss_and_grads(model: Layer, loss_fn: LossFn, params, model_state, rng,
                   inputs, labels, *, metrics_fn=None):
    """One forward and backward: (loss, new model state, grads with the
    params' tree, metrics). The loss is detached; nothing syncs with the
    host."""
    tracked = tree_map(
        lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    live = tree_leaves(tracked)
    with torch.enable_grad():
        out, new_mstate = model.apply(tracked, model_state, *inputs,
                                      training=True, rng=rng)
        loss = loss_fn(out, *labels)
        got = iter(torch.autograd.grad(
            loss, [p for p in live if p.requires_grad], allow_unused=True))
    # integer leaves and leaves the loss does not reach get zeros
    grads = [next(got) if p.requires_grad else None for p in live]
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(live, grads))
    grads = tree_map(lambda _: next(it), params)
    with torch.no_grad():
        metrics = metrics_fn(out, *labels) if metrics_fn else {}
    return loss.detach(), new_mstate, grads, metrics


def make_train_step(model: Layer, loss_fn: LossFn, optimizer: Optimizer, *,
                    metrics_fn: Optional[Callable] = None,
                    donate: bool = True,
                    remat: bool = False, accum_steps: int = 1,
                    constrain_state_fn: Optional[Callable] = None,
                    aux_loss_weight: float = 0.0):
    """Build the train step: (state, rng, inputs, labels) -> (new_state,
    loss, metrics). loss_fn(outputs, *labels) -> scalar loss.

    `donate` is accepted for the JAX signature and has no effect: the
    optimizer updates the parameters and its state in place, so the step
    never holds a second copy of them, which is what the JAX step's
    donation buys. The state passed in is updated too, either way."""
    for what, on in (("remat", remat), ("accum_steps > 1", accum_steps != 1),
                     ("constrain_state_fn", constrain_state_fn is not None),
                     ("aux_loss_weight", bool(aux_loss_weight))):
        if on:
            raise NotImplementedError(
                f"make_train_step({what}) is not ported yet ({_QUEUE})")

    def step(state: TrainState, rng, inputs, labels):
        loss, new_mstate, grads, metrics = loss_and_grads(
            model, loss_fn, state.params, state.model_state, rng,
            _as_tuple(inputs), _as_tuple(labels), metrics_fn=metrics_fn)
        new_params, new_opt = optimizer.update(grads, state.opt_state,
                                               state.params, state.step)
        new_state = TrainState(
            params=new_params,
            model_state=merge_state(state.model_state, new_mstate),
            opt_state=new_opt,
            step=state.step + 1,
        )
        return new_state, loss, metrics

    return step


def make_eval_step(model: Layer, loss_fn: LossFn, *, metrics_fn=None):
    @torch.no_grad()
    def step(state: TrainState, inputs, labels):
        labels = _as_tuple(labels)
        out, _ = model.apply(state.params, state.model_state,
                             *_as_tuple(inputs), training=False)
        loss = loss_fn(out, *labels)
        metrics = metrics_fn(out, *labels) if metrics_fn else {}
        return loss, metrics

    return step


class Trainer:
    """Event-driven training loop.

    Batches are tuples: the first `num_inputs` entries are model inputs,
    the rest go to the loss. Numpy arrays or tensors; each is moved to
    the trainer's device (None -> cuda, which raises without a card).
    `seed` seeds two `torch.Generator`s: a CPU one from which
    `init_state` draws the parameters, and one on the trainer's device
    that each step gets as its `rng` (a Dropout's masks are drawn
    there)."""

    def __init__(self, model: Layer, loss_fn: LossFn, optimizer: Optimizer,
                 *, metrics_fn: Optional[Callable] = None,
                 num_inputs: int = 1, seed: int = 0, device=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.metrics_fn = metrics_fn
        self.num_inputs = num_inputs
        self.device = resolve_device(device)
        self._init_rng = torch.Generator().manual_seed(seed)
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._train_step = make_train_step(model, loss_fn, optimizer,
                                           metrics_fn=metrics_fn)
        self._eval_step = make_eval_step(model, loss_fn,
                                         metrics_fn=metrics_fn)

    def init_state(self, *input_specs) -> TrainState:
        params, mstate = self.model.init(self._init_rng, *input_specs,
                                         device=self.device)
        return TrainState.create(params, mstate, self.optimizer)

    def _split_batch(self, batch):
        if isinstance(batch, tuple) and len(batch) > self.num_inputs:
            put = lambda x: torch.as_tensor(x, device=self.device)
            return (tuple(put(x) for x in batch[:self.num_inputs]),
                    tuple(put(x) for x in batch[self.num_inputs:]))
        raise ValueError(
            f"batch of {len(batch)} fields with num_inputs={self.num_inputs}")

    def train(self, state: TrainState,
              batch_iter_factory: Callable[[], Iterable], *,
              num_passes: int = 1, event_handler: Optional[Callable] = None,
              test_iter_factory: Optional[Callable[[], Iterable]] = None
              ) -> TrainState:
        handler = event_handler or (lambda ev: None)
        for pass_id in range(num_passes):
            handler(E.BeginPass(pass_id))
            for batch_id, batch in enumerate(batch_iter_factory()):
                handler(E.BeginIteration(pass_id, batch_id))
                inputs, labels = self._split_batch(batch)
                state, loss, metrics = self._train_step(
                    state, self._rng, inputs, labels)
                # loss/metrics stay on the device: the event materializes
                # them only if the handler reads .cost/.metrics
                handler(E.EndIteration(pass_id, batch_id, cost=loss,
                                       metrics=metrics))
            results: Dict[str, float] = {}
            if test_iter_factory is not None:
                test_res = self.evaluate(state, test_iter_factory)
                results = {"test_cost": test_res.cost, **test_res.metrics}
                handler(E.TestResult(pass_id, test_res.cost,
                                     test_res.metrics))
            handler(E.EndPass(pass_id, results))
        return state

    def evaluate(self, state: TrainState, batch_iter_factory
                 ) -> E.TestResult:
        """Mean loss and metrics over the batches (no evaluators yet)."""
        total, n = 0.0, 0
        agg: Dict[str, float] = {}
        for batch in batch_iter_factory():
            inputs, labels = self._split_batch(batch)
            loss, metrics = self._eval_step(state, inputs, labels)
            total += float(loss)
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n += 1
        n = max(n, 1)
        return E.TestResult(-1, total / n, {k: v / n for k, v in agg.items()})
