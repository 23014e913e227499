"""Event-driven trainer (port of `paddle_tpu.train.trainer`:
`make_train_step`, `make_eval_step` and `Trainer`).

The JAX step is one jitted program; here it runs eagerly: forward,
`torch.autograd.grad` over the parameter tree's leaves (kernels get
their gradients through their `torch.autograd.Function`s), then the
optimizer's in-place update. The loss stays on the device; an
`EndIteration` event reads it only when its handler asks.

The step's options are JAX's: `remat` (the forward recomputed in the
backward, through `nn.composite.Remat`, which replays a Dropout's
generator so the recompute draws the forward's masks), `accum_steps`
(microbatches, one update on the mean gradient), `constrain_state_fn`
and `aux_loss_weight`. `Trainer` adds `check_gradients` (float64, as
JAX's), checkpoints and parameter stats in `train`, and streaming
evaluators in `evaluate`.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map, tree_map_multi
from paddle_tpu_torch.metrics.printer import (format_parameter_stats,
                                              host_array, parameter_stats)
from paddle_tpu_torch.nn.composite import Remat
from paddle_tpu_torch.nn.module import Layer, merge_state
from paddle_tpu_torch.optim.optimizers import Optimizer
from paddle_tpu_torch.train import events as E
from paddle_tpu_torch.train.state import TrainState

LossFn = Callable[..., torch.Tensor]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _aux_losses(tree):
    """Every `aux_loss` leaf of a model state, in JAX's flatten order
    (dict keys sorted), so the cost sums them in JAX's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            if k == "aux_loss" and isinstance(tree[k], torch.Tensor):
                yield tree[k]
            else:
                yield from _aux_losses(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _aux_losses(v)


def loss_and_grads(model: Layer, loss_fn: LossFn, params, model_state, rng,
                   inputs, labels, *, metrics_fn=None,
                   aux_loss_weight: float = 0.0):
    """One forward and backward: (loss, new model state, grads with the
    params' tree, metrics). aux_loss_weight > 0 adds that multiple of
    every `aux_loss` leaf of the new model state to the loss. The loss is
    detached; nothing syncs with the host."""
    tracked = tree_map(
        lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    live = tree_leaves(tracked)
    with torch.enable_grad():
        out, new_mstate = model.apply(tracked, model_state, *inputs,
                                      training=True, rng=rng)
        loss = loss_fn(out, *labels)
        if aux_loss_weight:
            for aux in _aux_losses(new_mstate):
                loss = loss + aux_loss_weight * aux
        got = iter(torch.autograd.grad(
            loss, [p for p in live if p.requires_grad], allow_unused=True))
    # integer leaves and leaves the loss does not reach get zeros
    grads = [next(got) if p.requires_grad else None for p in live]
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(live, grads))
    grads = tree_map(lambda _: next(it), params)
    with torch.no_grad():
        metrics = metrics_fn(out, *labels) if metrics_fn else {}
    # the new state (an aux_loss above all) must not hold the graph
    new_mstate = tree_map(
        lambda t: t.detach() if isinstance(t, torch.Tensor) else t,
        new_mstate)
    return loss.detach(), new_mstate, grads, metrics


def make_train_step(model: Layer, loss_fn: LossFn, optimizer: Optimizer, *,
                    metrics_fn: Optional[Callable] = None,
                    donate: bool = True,
                    remat: bool = False, accum_steps: int = 1,
                    constrain_state_fn: Optional[Callable] = None,
                    aux_loss_weight: float = 0.0):
    """Build the train step: (state, rng, inputs, labels) -> (new_state,
    loss, metrics). loss_fn(outputs, *labels) -> scalar loss.

    donate=True: the optimizer updates the parameters and its state in
    place, so the state passed in is updated too and no second copy of
    them is made (what the JAX step's donation buys). donate=False: the
    step copies them first and leaves the state passed in as it was (one
    extra copy of params and optimizer state, as JAX's non-donating step).

    remat=True recomputes the forward in the backward (`Remat` around the
    model, saving nothing inside it). accum_steps > 1 splits the batch
    into that many microbatches (the batch must divide, else ValueError),
    runs forward and backward on each against the same parameters with
    the model state merged microbatch by microbatch, and applies ONE
    update on the mean of their gradients (summed in f32); loss and
    metrics are microbatch means. Each microbatch draws its randomness
    from `rng` in turn. constrain_state_fn(new_state) -> new_state is
    applied to the updated state. aux_loss_weight: see loss_and_grads."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    applied = Remat(model, policy=None) if remat else model

    def fwd_bwd(params, mstate, rng, inputs, labels):
        return loss_and_grads(applied, loss_fn, params, mstate, rng, inputs,
                              labels, metrics_fn=metrics_fn,
                              aux_loss_weight=aux_loss_weight)

    def split(x):
        if x.shape[0] % accum_steps != 0:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"accum_steps={accum_steps}")
        return x.reshape((accum_steps, -1) + tuple(x.shape[1:]))

    def accumulated(state, rng, inputs, labels):
        m_inputs = [split(x) for x in inputs]
        m_labels = [split(x) for x in labels]
        mstate = state.model_state
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device),
                         state.params)
        loss, metrics = None, None
        for i in range(accum_steps):
            l_i, new_ms, g_i, m_i = fwd_bwd(
                state.params, mstate, rng, tuple(x[i] for x in m_inputs),
                tuple(x[i] for x in m_labels))
            grads = tree_map_multi(torch.add, grads, g_i)
            loss = l_i.float() if loss is None else loss + l_i
            metrics = (dict(m_i) if metrics is None else
                       {k: metrics[k] + v for k, v in m_i.items()})
            mstate = merge_state(mstate, new_ms)
        inv = 1.0 / accum_steps
        grads = tree_map(lambda g: g * inv, grads)
        return (loss * inv, mstate, grads,
                {k: v * inv for k, v in metrics.items()})

    def step(state: TrainState, rng, inputs, labels):
        inputs, labels = _as_tuple(inputs), _as_tuple(labels)
        if accum_steps == 1:
            loss, new_mstate, grads, metrics = fwd_bwd(
                state.params, state.model_state, rng, inputs, labels)
        else:
            loss, new_mstate, grads, metrics = accumulated(
                state, rng, inputs, labels)
        params, opt_state = state.params, state.opt_state
        if not donate:
            params = tree_map(torch.clone, params)
            opt_state = tree_map(torch.clone, opt_state)
        new_params, new_opt = optimizer.update(grads, opt_state, params,
                                               state.step)
        new_state = TrainState(
            params=new_params,
            model_state=merge_state(state.model_state, new_mstate),
            opt_state=new_opt,
            step=state.step + 1,
        )
        if constrain_state_fn is not None:
            new_state = constrain_state_fn(new_state)
        return new_state, loss, metrics

    return step


def make_eval_step(model: Layer, loss_fn: LossFn, *, metrics_fn=None,
                   return_outputs: bool = False):
    @torch.no_grad()
    def step(state: TrainState, inputs, labels):
        labels = _as_tuple(labels)
        out, _ = model.apply(state.params, state.model_state,
                             *_as_tuple(inputs), training=False)
        loss = loss_fn(out, *labels)
        metrics = metrics_fn(out, *labels) if metrics_fn else {}
        if return_outputs:
            return loss, metrics, out
        return loss, metrics

    return step


class Trainer:
    """Event-driven training loop.

    Batches are tuples: the first `num_inputs` entries are model inputs,
    the rest go to the loss. Numpy arrays or tensors; each is moved to
    the trainer's device (None -> cuda, which raises without a card).
    `seed` seeds two `torch.Generator`s: a CPU one from which
    `init_state` draws the parameters, and one on the trainer's device
    that each step of `train` gets as its `rng` (a Dropout's masks are
    drawn there). `seed` is kept: `train.resilience` derives each step's
    generator from it and the step's index instead."""

    def __init__(self, model: Layer, loss_fn: LossFn, optimizer: Optimizer,
                 *, metrics_fn: Optional[Callable] = None,
                 num_inputs: int = 1, seed: int = 0, remat: bool = False,
                 aux_loss_weight: float = 0.0, device=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.metrics_fn = metrics_fn
        self.num_inputs = num_inputs
        self.seed = seed
        # kept so wrappers (train.resilience) can rebuild an equivalent
        # step with other donation or optimizer settings
        self.remat = remat
        self.aux_loss_weight = aux_loss_weight
        self.device = resolve_device(device)
        self._init_rng = torch.Generator().manual_seed(seed)
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._train_step = make_train_step(
            model, loss_fn, optimizer, metrics_fn=metrics_fn, remat=remat,
            aux_loss_weight=aux_loss_weight)
        self._eval_step = make_eval_step(model, loss_fn,
                                         metrics_fn=metrics_fn)
        self._eval_step_with_outputs = make_eval_step(
            model, loss_fn, metrics_fn=metrics_fn, return_outputs=True)

    def init_state(self, *input_specs) -> TrainState:
        params, mstate = self.model.init(self._init_rng, *input_specs,
                                         device=self.device)
        return TrainState.create(params, mstate, self.optimizer)

    def check_gradients(self, state: TrainState, batch, *,
                        eps: float = 1e-3, num_directions: int = 4,
                        seed: int = 0) -> float:
        """`--job=checkgrad`: the autograd directional derivative against
        a central finite difference along `num_directions` random
        parameter directions (drawn from a CPU generator seeded with
        `seed`), in float64 with the float64 compute policy for the
        duration, as the JAX package's. Returns the worst relative
        error. A kernel path given float64 raises (the time-loop
        kernels take f32 and bf16): check a model built with
        impl="torch"."""
        inputs, labels = self._split_batch(batch)
        f64 = torch.float64
        old_policy = dtypes.default_policy()
        try:
            dtypes.set_default_policy(dtypes.Policy(compute_dtype=f64,
                                                    accum_dtype=f64))
            params0 = tree_map(lambda p: p.detach().to(f64), state.params)
            inputs = tuple(x.to(f64) if x.is_floating_point() else x
                           for x in inputs)

            def scalar_loss(params):
                outs, _ = self.model.apply(params, state.model_state,
                                           *inputs, training=False, rng=None)
                return self.loss_fn(outs, *labels).to(f64)

            leaves = tree_leaves(params0)
            live = [p.clone().requires_grad_() for p in leaves]
            it = iter(live)
            with torch.enable_grad():
                grads = torch.autograd.grad(
                    scalar_loss(tree_map(lambda _: next(it), params0)), live)
            gen = torch.Generator().manual_seed(seed)
            worst = 0.0
            with torch.no_grad():
                for _ in range(num_directions):
                    dirs = [torch.randn(p.shape, generator=gen, dtype=f64)
                            .to(p.device) for p in leaves]
                    norm = torch.sqrt(sum(torch.sum(d * d) for d in dirs))
                    dirs = [d / norm for d in dirs]
                    analytic = float(sum(torch.sum(g * d)
                                         for g, d in zip(grads, dirs)))

                    def moved(sign):
                        it = iter(p + sign * eps * d
                                  for p, d in zip(leaves, dirs))
                        return tree_map(lambda _: next(it), params0)

                    numeric = float((scalar_loss(moved(1.0))
                                     - scalar_loss(moved(-1.0))) / (2 * eps))
                    denom = max(abs(numeric), abs(analytic), 1e-12)
                    worst = max(worst, abs(numeric - analytic) / denom)
            return worst
        finally:
            dtypes.set_default_policy(old_policy)

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
              test_iter_factory: Optional[Callable[[], Iterable]] = None,
              checkpoint_manager=None,
              checkpoint_every_n_batches: Optional[int] = None,
              parameter_stats_period: Optional[int] = None) -> TrainState:
        """checkpoint_manager (`train.checkpoint.CheckpointManager`):
        saves every `checkpoint_every_n_batches` batches of a pass if
        set, and at the end of each pass unless that step is already
        saved. parameter_stats_period: print per-parameter magnitude
        dumps every N batches."""
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
                if (parameter_stats_period
                        and (batch_id + 1) % parameter_stats_period == 0):
                    print(f"--- parameter stats (pass {pass_id} batch "
                          f"{batch_id}) ---")
                    print(format_parameter_stats(
                        parameter_stats(state.params)))
                if (checkpoint_manager is not None
                        and checkpoint_every_n_batches
                        and (batch_id + 1) % checkpoint_every_n_batches == 0):
                    checkpoint_manager.save(state)
            if (checkpoint_manager is not None
                    and checkpoint_manager.latest_step() != int(state.step)):
                checkpoint_manager.save(state)
            results: Dict[str, float] = {}
            if test_iter_factory is not None:
                test_res = self.evaluate(state, test_iter_factory)
                results = {"test_cost": test_res.cost, **test_res.metrics}
                handler(E.TestResult(pass_id, test_res.cost,
                                     test_res.metrics))
            handler(E.EndPass(pass_id, results))
        return state

    def evaluate(self, state: TrainState, batch_iter_factory,
                 evaluators=None) -> E.TestResult:
        """Mean loss and metrics over the batches. `evaluators`
        (`metrics.Evaluator` objects) are reset, get update(outputs,
        *labels) per batch as host numpy arrays -- the evaluator API's
        contract, as in the JAX package -- and their results are merged
        into the returned metrics (a second evaluator of the same name
        reports as "name#1")."""
        total, n = 0.0, 0
        agg: Dict[str, float] = {}
        for ev in evaluators or ():
            ev.reset()
        for batch in batch_iter_factory():
            inputs, labels = self._split_batch(batch)
            if evaluators:
                loss, metrics, out = self._eval_step_with_outputs(
                    state, inputs, labels)
                host_out = host_array(out)
                host_labels = [host_array(l) for l in labels]
                for ev in evaluators:
                    ev.update(host_out, *host_labels)
            else:
                loss, metrics = self._eval_step(state, inputs, labels)
            total += float(loss)
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n += 1
        n = max(n, 1)
        results = {k: v / n for k, v in agg.items()}
        seen: Dict[str, int] = {}
        for ev in evaluators or ():
            count = seen.get(ev.name, 0)
            seen[ev.name] = count + 1
            base = ev.name if count == 0 else f"{ev.name}#{count}"
            r = ev.result()
            if isinstance(r, dict):
                for k, v in r.items():
                    results[f"{base}/{k}"] = v
            else:
                results[base] = r
        return E.TestResult(-1, total / n, results)
