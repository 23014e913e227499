"""Fault-tolerant training runtime (port of `paddle_tpu.train.resilience`):
the loop that survives preemption, divergence and hangs.

- **Preemption-safe resume**: `ResilientTrainer.run()` restores the
  newest restorable checkpoint at startup (falling back past corrupt
  steps), installs SIGTERM/SIGINT handlers that drain ONE final save at
  the next step boundary, and raises `Preempted` so a restart lands
  exactly where the save left off.
- **Divergence guard**: every step's loss is read on the host (one sync
  per step) and checked (non-finite, or a spike over a running EMA). A
  bad step is skipped or rolled back to the last checkpoint, with
  optional LR backoff, and `DivergenceError` ends the run once the
  budget is spent.
- **Watchdog**: a progress deadline; every completed step pets it, and
  the default action force-exits the process (exit 75) so a scheduler
  restarts it into the resume path.

The knobs, the event sequence and the recovery decisions are JAX's. The
one thing this module cannot copy is per-step randomness: JAX derives a
step's key as `fold_in(base, global_batch_index)`. Here each step gets
a device generator seeded with a fixed mix (splitmix64) of the trainer's
seed and the global batch index, so a replayed or resumed step draws
exactly what the uninterrupted run drew; a generator advanced step after
step, as `Trainer.train`'s, would not.

The obs seams are JAX's: `tracer` opens one span per executed step
attempt, `flight` records bad steps and the preemption drain and dumps
its ring to `flight_dir` (default the checkpoint directory) on a
divergence rollback, an exhausted budget and the drain, and
`bind_metrics` registers the outcome ledger. The elastic seams are
JAX's: `step_builder(optimizer) -> step` replaces the plain step (the
ZeRO step of `train --zero` and the gang members) and is called again
with the grad-scaled optimizer after an LR backoff; `gang_epoch` tags
every step span and `counters()`. The `pserver_client` seam is JAX's: a
`parallel.pserver_client.PServerClient` whose push/pull events ride the
live step attempt's span (its `obs_hook`) and whose exactly-once ledger
`bind_metrics` registers under `{prefix}_pserver`.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import signal
import sys
import threading
import time
from typing import Any, Callable, Iterable, List, Optional

import torch

from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.optim.optimizers import Optimizer
from paddle_tpu_torch.train import events as E
from paddle_tpu_torch.train.checkpoint import (CheckpointManager,
                                               ManifestMismatchError)
from paddle_tpu_torch.train.state import TrainState
from paddle_tpu_torch.train.trainer import Trainer, make_train_step

log = logging.getLogger(__name__)

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def step_seed(seed: int, gidx: int) -> int:
    """The seed of global batch `gidx`'s generator: a fixed mix of the
    trainer's seed and the index, the same in every process."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ gidx)


class Preempted(RuntimeError):
    """Raised after the final drain save when a preemption signal
    arrived. `.step` is the checkpointed step; a process restarted with
    the same checkpoint_dir resumes from it."""

    def __init__(self, step: int, signum: Optional[int] = None):
        super().__init__(
            f"preempted at step {step} (signal {signum}); state saved — "
            f"restart resumes here")
        self.step = step
        self.signum = signum


class DivergenceError(RuntimeError):
    """The bad-step budget is spent: training diverges faster than the
    recovery policy can absorb."""

    def __init__(self, bad_steps: List["BadStep"]):
        last = bad_steps[-1] if bad_steps else None
        super().__init__(
            f"{len(bad_steps)} bad steps exhausted the recovery budget"
            + (f"; last: {last}" if last else ""))
        self.bad_steps = bad_steps


@dataclasses.dataclass
class BadStep:
    """One detected-and-handled divergent step (audit trail)."""

    step: int
    pass_id: int
    batch_id: int
    reason: str       # "non-finite loss" | "loss spike: ..."
    action: str       # "skip" | "rollback" | "fail"
    loss: float


class _Rollback(Exception):
    """Internal: unwind the drive loop back to a restored state."""

    def __init__(self, state: TrainState):
        self.state = state


class Watchdog:
    """Progress deadline for the train loop. `pet()` after every unit of
    progress; if `timeout_s` passes without one, `on_timeout(elapsed)`
    runs once on the watchdog thread. The default action force-exits the
    process with EXIT_CODE (`os._exit`: a main thread blocked in a device
    wait cannot be reached by an exception or a signal)."""

    #: "aborted by watchdog": distinct from clean exits and from
    #: SIGTERM's 143
    EXIT_CODE = 75

    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[float], None]] = None,
                 *, poll_s: Optional[float] = None,
                 name: str = "paddle-tpu-torch-watchdog",
                 clock: Callable[[], float] = time.monotonic):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout or self._default_abort
        self._poll_s = poll_s if poll_s is not None else min(
            timeout_s / 4.0, 1.0)
        self._name = name
        self.clock = clock
        self._last = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    def _default_abort(self, elapsed: float) -> None:
        reason = (f"watchdog: no training progress for {elapsed:.1f}s "
                  f"(deadline {self.timeout_s}s); exiting for the "
                  f"scheduler to restart")
        log.critical("aborting process %d: %s", os.getpid(), reason)
        try:
            sys.stderr.write(f"paddle_tpu_torch ABORT: {reason}\n")
            sys.stderr.flush()
        except OSError:
            pass
        os._exit(self.EXIT_CODE)

    def start(self) -> "Watchdog":
        self._last = self.clock()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=self._name, daemon=True)
        self._thread.start()
        return self

    def pet(self) -> None:
        self._last = self.clock()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            elapsed = self.clock() - self._last
            if elapsed >= self.timeout_s:
                self.fired = True
                try:
                    self.on_timeout(elapsed)
                finally:
                    # one shot: a custom action that does not kill the
                    # process is not re-fired every poll
                    self._stop.set()
                return

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def restore_with_fallback(manager, template: TrainState, *,
                          bad_steps: Optional[List[int]] = None):
    """Restore the NEWEST restorable step, walking back past corrupt ones.

    Returns (state, step); (template, None) when the directory holds no
    checkpoints. Raises RuntimeError when checkpoints exist but none
    restores (a template/directory mismatch: starting over would let
    retention delete the real run), and re-raises ManifestMismatchError
    at once (every older step mismatches the same way). `bad_steps`, when
    given, collects the steps that failed to restore: the caller's save
    path must not treat them as durable."""
    try:
        steps = sorted(manager.all_steps(), reverse=True)
    except FileNotFoundError:
        return template, None
    errors = []
    for step in steps:
        try:
            return manager.restore(template, step=step), step
        except ManifestMismatchError:
            raise
        except Exception as e:  # any unreadable step: walk back past it
            errors.append((step, e))
            if bad_steps is not None:
                bad_steps.append(step)
            log.warning("checkpoint step %d unrestorable (%s); falling "
                        "back to the previous step", step, e)
    if steps:
        raise RuntimeError(
            f"{len(steps)} checkpoint step(s) exist under "
            f"{getattr(manager, 'directory', '?')} but none is "
            f"restorable with this state template — architecture/"
            f"directory mismatch? last error: step {errors[-1][0]}: "
            f"{errors[-1][1]}")
    return template, None


def _scale_grads(optimizer: Optimizer, scale: float) -> Optimizer:
    """Optimizer wrapper scaling the gradients: the LR backoff that needs
    no optimizer-internal access (exact for the SGD family, a damper for
    normalized optimizers like Adam). The opt_state layout is unchanged,
    so checkpoints restore across backoffs."""

    def update(grads, opt_state, params, step):
        grads = tree_map(lambda g: g * scale, grads)
        return optimizer.update(grads, opt_state, params, step)

    return Optimizer(optimizer.init, update)


class ResilientTrainer:
    """Preemption-safe, divergence-guarded driver around a `Trainer`.

    Drives a NON-donating train step (`make_train_step(donate=False)`:
    one extra copy of params and optimizer state, the price of
    discarding a bad update) and the batch loop itself, so every step
    boundary is a recovery point.

    - `run()` restores the newest restorable checkpoint first; with a
      deterministic `batch_iter_factory` a preempted and restarted run
      reaches params IDENTICAL to an uninterrupted one.
    - a non-finite (or, with `loss_spike_factor`, spiking) loss triggers
      `bad_step_policy`: "skip" discards the update but advances the
      step counter (step == batches consumed, so resume cursors never
      desync); "rollback" restores the last checkpoint (the LR backed off
      by `lr_backoff` if set) and replays. At most `max_bad_steps` times,
      then `DivergenceError`; `bad_step_reset_after` healthy steps of new
      progress clear the budget.
    - SIGTERM/SIGINT: one save at the next step boundary, then
      `Preempted`.
    - `watchdog_timeout_s` bounds any hang; saves and restores pet it on
      both sides.

    Saves other than the drain absorb OSError (listed in `.save_errors`,
    training goes on); the drain retries, then re-raises.
    """

    def __init__(self, trainer: Trainer, checkpoint_dir: str, *,
                 max_to_keep: int = 3,
                 checkpoint_every_n_batches: Optional[int] = None,
                 bad_step_policy: str = "rollback",
                 max_bad_steps: int = 3,
                 bad_step_reset_after: Optional[int] = 100,
                 loss_spike_factor: Optional[float] = None,
                 lr_backoff: Optional[float] = None,
                 watchdog_timeout_s: Optional[float] = None,
                 watchdog_on_timeout: Optional[Callable] = None,
                 install_signal_handlers: bool = True,
                 checkpoint_manager: Optional[Any] = None,
                 tracer: Optional[Any] = None,
                 flight: Optional[Any] = None,
                 flight_dir: Optional[str] = None,
                 pserver_client: Optional[Any] = None,
                 step_builder: Optional[Callable] = None,
                 gang_epoch: int = 0):
        if bad_step_policy not in ("skip", "rollback"):
            raise ValueError(
                f"bad_step_policy must be skip|rollback, got "
                f"{bad_step_policy!r}")
        if lr_backoff is not None and not (0.0 < lr_backoff < 1.0):
            raise ValueError(f"lr_backoff must be in (0, 1), got "
                             f"{lr_backoff}")
        self.trainer = trainer
        self.manager = checkpoint_manager or CheckpointManager(
            checkpoint_dir, max_to_keep=max_to_keep)
        self.checkpoint_every_n_batches = checkpoint_every_n_batches
        self.bad_step_policy = bad_step_policy
        self.max_bad_steps = max_bad_steps
        self.bad_step_reset_after = bad_step_reset_after
        self.loss_spike_factor = loss_spike_factor
        self.lr_backoff = lr_backoff
        self.watchdog_timeout_s = watchdog_timeout_s
        self.watchdog_on_timeout = watchdog_on_timeout
        self.install_signal_handlers = install_signal_handlers
        # observability (paddle_tpu_torch.obs), host-side only, both
        # default off: one span per executed step attempt, the flight
        # ring dumped next to the checkpoints on the fault paths
        self.tracer = tracer
        self.flight = flight
        self.flight_dir = flight_dir or checkpoint_dir
        # pserver push/pull events ride the live step span (the client's
        # obs_hook seam) so the trainer step -> pserver trail is one trace
        self.pserver_client = pserver_client
        # the elastic seams: step_builder(optimizer) -> step replaces the
        # plain step (and rebuilds it after an LR backoff); gang_epoch
        # tags spans and counters, so a reformed gang's are told apart
        self.step_builder = step_builder
        self.gang_epoch = int(gang_epoch)
        self.bad_steps: List[BadStep] = []
        self.save_errors: List[str] = []
        self.restored_step: Optional[int] = None
        self._lr_scale = 1.0
        self._preempt_signum: Optional[int] = None
        # the FAIL decision reads _bad_used, which bad_step_reset_after
        # steps of NEW progress (not rollback replays) clear
        self._bad_used = 0
        self._progress_since_bad = 0
        self._max_step_reached = 0
        # steps whose checkpoints exist but FAILED to restore: the
        # latest-step save dedupe must not treat them as durable
        self._corrupt_steps: set = set()
        self._watchdog: Optional[Watchdog] = None
        self._build_step()

    def counters(self) -> dict:
        """Outcome counts (numeric values only): the state the recovery
        policy decides on."""
        return {
            "bad_steps": len(self.bad_steps),
            "bad_used": self._bad_used,
            "progress_since_bad": self._progress_since_bad,
            "max_step_reached": self._max_step_reached,
            "save_errors": len(self.save_errors),
            "corrupt_steps": len(self._corrupt_steps),
            "restored_step": (-1 if self.restored_step is None
                              else self.restored_step),
            "lr_scale": self._lr_scale,
            "watchdog_fired": (self._watchdog is not None
                               and self._watchdog.fired),
            "gang_epoch": self.gang_epoch,
            "reshard_restores": int(getattr(self.manager,
                                            "reshard_restores", 0)),
        }

    def bind_metrics(self, registry, *, prefix: str = "train",
                     labels: Optional[dict] = None) -> None:
        """Attach the outcome ledger (and the tracer's and flight
        recorder's own counts) to an `obs.MetricsRegistry`."""
        registry.register_source(prefix, self.counters, labels=labels)
        if self.tracer is not None:
            registry.register_source(f"{prefix}_trace",
                                     self.tracer.counters, labels=labels)
        if self.flight is not None:
            registry.register_source(f"{prefix}_flight",
                                     self.flight.counters, labels=labels)
        if self.pserver_client is not None:
            self.pserver_client.bind_metrics(
                registry, prefix=f"{prefix}_pserver", labels=labels)

    def _flight_dump(self, reason: str, /, **extra) -> None:
        # positional-only: the fault paths carry their own `reason=` tag
        if self.flight is None or not self.flight_dir:
            return
        self.flight.dump(self.flight_dir, reason,
                         extra={**extra, "counters": self.counters()})

    def _build_step(self) -> None:
        tr = self.trainer
        opt = tr.optimizer
        if self._lr_scale != 1.0:
            opt = _scale_grads(opt, self._lr_scale)
        if self.step_builder is not None:
            self._step = self.step_builder(opt)
            return
        # donate=False: the previous state must survive the step so a
        # bad update can be discarded without touching the checkpoint
        self._step = make_train_step(
            tr.model, tr.loss_fn, opt, metrics_fn=tr.metrics_fn,
            donate=False, remat=tr.remat,
            aux_loss_weight=tr.aux_loss_weight)

    # -- signals ----------------------------------------------------------

    def _install_signals(self):
        """SIGTERM/SIGINT set a flag; the loop drains at the next step
        boundary (saving mid-step would checkpoint a half-applied
        update). Returns the previous handlers, or None off the main
        thread."""
        self._preempt_signum = None

        def handler(signum, frame):
            # a flag only: logging here could re-enter its locks
            self._preempt_signum = signum

        try:
            prev = {s: signal.signal(s, handler)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        except ValueError:      # not the main thread
            return None
        return prev

    @staticmethod
    def _restore_signals(prev) -> None:
        if prev:
            for s, h in prev.items():
                signal.signal(s, h)

    # -- checkpointing ----------------------------------------------------

    def _pet(self) -> None:
        if self._watchdog is not None:
            self._watchdog.pet()

    def _save(self, state: TrainState, *, drain: bool = False) -> None:
        """Cadence saves absorb OSError (visible in .save_errors); the
        drain retries, then propagates."""
        self._pet()
        step = int(state.step)
        if (self.manager.latest_step() == step
                and step not in self._corrupt_steps):
            return      # this step is already durable
        attempts = 3 if drain else 1
        for i in range(attempts):
            try:
                # save() replaces an existing step directory, so a
                # known-corrupt one is overwritten here, not kept
                self.manager.save(state)
                self._corrupt_steps.discard(step)
                self._pet()
                return
            except OSError as e:
                self.save_errors.append(f"step {step}: {e}")
                log.warning("checkpoint save at step %d failed: %s", step,
                            e)
                if drain and i + 1 < attempts:
                    time.sleep(0.1 * (2 ** i))
        if drain:
            raise OSError(f"drain save at step {step} failed {attempts} "
                          f"times: {self.save_errors[-1]}")

    def _maybe_drain(self, state: TrainState) -> None:
        if self._preempt_signum is None:
            return
        log.warning("preemption signal %d received; draining one final "
                    "checkpoint at step boundary %d", self._preempt_signum,
                    int(state.step))
        if self.flight is not None:
            self.flight.record("signal", "preemption-drain",
                               signum=self._preempt_signum,
                               step=int(state.step))
        self._save(state, drain=True)
        self._flight_dump(f"sigterm-{self._preempt_signum}",
                          step=int(state.step))
        raise Preempted(int(state.step), self._preempt_signum)

    # -- divergence guard -------------------------------------------------

    def _classify(self, loss: float, ema: Optional[float]) -> Optional[str]:
        if not math.isfinite(loss):
            return "non-finite loss"
        if (self.loss_spike_factor is not None and ema is not None
                and abs(loss) > self.loss_spike_factor * max(abs(ema),
                                                             1e-8)):
            return (f"loss spike: |{loss:.4g}| > "
                    f"{self.loss_spike_factor:g} * |{ema:.4g}|")
        return None

    def _handle_bad_step(self, prev_state: TrainState, pass_id: int,
                         batch_id: int, loss: float,
                         reason: str) -> TrainState:
        """Returns the state to continue from (skip) or raises
        _Rollback/DivergenceError."""
        action = self.bad_step_policy
        self.bad_steps.append(BadStep(
            step=int(prev_state.step), pass_id=pass_id,
            batch_id=batch_id, reason=reason, action=action, loss=loss))
        self._bad_used += 1
        self._progress_since_bad = 0
        if self.flight is not None:
            self.flight.record("fault", "bad-step",
                               step=int(prev_state.step),
                               pass_id=pass_id, batch_id=batch_id,
                               reason=reason, action=action,
                               loss=loss, bad_used=self._bad_used)
        if self._bad_used > self.max_bad_steps:
            self.bad_steps[-1].action = "fail"
            self._flight_dump("divergence-budget-exhausted",
                              reason=reason)
            raise DivergenceError(self.bad_steps)
        log.warning("bad step %d (pass %d batch %d): %s -> %s "
                    "(%d/%d recoveries used)", int(prev_state.step),
                    pass_id, batch_id, reason, action,
                    self._bad_used, self.max_bad_steps)
        if action == "skip":
            # discard the update but ADVANCE the step counter: step must
            # stay == batches consumed, or a later resume would re-apply
            # an already-checkpointed batch
            return prev_state._replace(step=prev_state.step + 1)
        # rollback: restore the last durable state and replay from there,
        # the LR optionally backed off
        if self.lr_backoff is not None:
            self._lr_scale *= self.lr_backoff
            log.warning("LR backoff: grad scale now %.4g", self._lr_scale)
            self._build_step()
        self._pet()
        bad: List[int] = []
        restored, step = restore_with_fallback(self.manager, prev_state,
                                               bad_steps=bad)
        self._corrupt_steps.update(bad)
        if step is None:
            self._flight_dump("divergence-no-restore-target",
                              reason=reason)
            raise DivergenceError(self.bad_steps)
        self._pet()
        self._flight_dump("divergence-rollback", reason=reason,
                          restored_step=step)
        raise _Rollback(restored)

    # -- the drive loop ---------------------------------------------------

    def run(self, state: TrainState,
            batch_iter_factory: Callable[[], Iterable], *,
            num_passes: int = 1,
            event_handler: Optional[Callable] = None) -> TrainState:
        """Run `num_passes` over `batch_iter_factory` with the full
        recovery loop. `state` is the FRESH-INIT state (the template); if
        checkpoints exist, the newest restorable one wins.

        Resume contract: `batch_iter_factory` must be deterministic (the
        same batches in the same order on every call): resume skips the
        first `restored_step` batches and replays the rest, each step's
        generator seeded by `step_seed(trainer.seed, global batch
        index)`."""
        bad_restore_steps: List[int] = []
        restored, step = restore_with_fallback(
            self.manager, state, bad_steps=bad_restore_steps)
        self._corrupt_steps.update(bad_restore_steps)
        if step is not None:
            log.info("resuming from checkpoint step %d under %s", step,
                     getattr(self.manager, "directory", "?"))
            self.restored_step = step
            state = restored
        else:
            # a durable step-0 anchor: the rollback policy always has a
            # target, and a preemption before the first cadence save
            # still resumes
            self._save(state)
        step_rng = torch.Generator(device=self.trainer.device)
        prev_handlers = (self._install_signals()
                         if self.install_signal_handlers else None)
        watchdog = None
        if self.watchdog_timeout_s is not None:
            watchdog = Watchdog(self.watchdog_timeout_s,
                                self.watchdog_on_timeout).start()
        self._watchdog = watchdog
        try:
            while True:
                try:
                    return self._drive(state, batch_iter_factory, step_rng,
                                       num_passes, event_handler)
                except _Rollback as rb:
                    state = rb.state
        finally:
            self._watchdog = None
            if watchdog is not None:
                watchdog.stop()
            self._restore_signals(prev_handlers)

    def _drive(self, state, batch_iter_factory, step_rng, num_passes,
               event_handler) -> TrainState:
        handler = event_handler or (lambda ev: None)
        resume_from = int(state.step)
        gidx = 0            # global batch cursor across passes
        ema: Optional[float] = None
        cadence = self.checkpoint_every_n_batches
        for pass_id in range(num_passes):
            # event parity with Trainer.train: BeginPass fires before the
            # pass's first EXECUTED batch
            began = gidx >= resume_from
            if began:
                handler(E.BeginPass(pass_id))
            for batch_id, batch in enumerate(batch_iter_factory()):
                if gidx < resume_from:
                    gidx += 1
                    self._pet()     # skipping ahead is progress too
                    continue
                if not began:
                    handler(E.BeginPass(pass_id))
                    began = True
                self._maybe_drain(state)
                handler(E.BeginIteration(pass_id, batch_id))
                span = None
                if self.tracer is not None:
                    # one span per executed attempt: a rollback replay
                    # of the same gidx opens a fresh span under its id
                    span = self.tracer.start(
                        f"step{gidx}", "train.step", pass_id=pass_id,
                        batch_id=batch_id, gang_epoch=self.gang_epoch)
                    if self.pserver_client is not None:
                        # point the client's obs seam at THIS attempt's
                        # span; Span.event on a closed span is a no-op,
                        # so a stale hook between steps is harmless
                        self.pserver_client.obs_hook = (
                            lambda event, ctx, _s=span:
                            _s.event(event, **ctx))
                inputs, labels = self.trainer._split_batch(batch)
                step_rng.manual_seed(step_seed(self.trainer.seed, gidx))
                prev_state = state
                state, loss, metrics = self._step(state, step_rng, inputs,
                                                  labels)
                # the guard IS a host sync per step: the price of
                # detecting divergence before it becomes the checkpoint
                lossf = float(loss)
                reason = self._classify(lossf, ema)
                if reason is not None:
                    # every BeginIteration gets a closing EndIteration,
                    # carrying the disposition
                    try:
                        state = self._handle_bad_step(
                            prev_state, pass_id, batch_id, lossf, reason)
                    except (_Rollback, DivergenceError):
                        if span is not None:
                            self.tracer.end(
                                span, self.bad_steps[-1].action,
                                reason=reason, loss=lossf)
                        handler(E.EndIteration(
                            pass_id, batch_id, cost=loss,
                            outcome=self.bad_steps[-1].action))
                        raise
                    if span is not None:
                        self.tracer.end(span, "skip", reason=reason,
                                        loss=lossf)
                    handler(E.EndIteration(pass_id, batch_id, cost=loss,
                                           outcome="skip"))
                    gidx += 1
                    self._pet()
                    continue
                ema = lossf if ema is None else 0.9 * ema + 0.1 * lossf
                # only NEW progress (not rollback replays) ticks the
                # healthy-step window that clears the budget
                if gidx + 1 > self._max_step_reached:
                    self._max_step_reached = gidx + 1
                    self._progress_since_bad += 1
                    if (self.bad_step_reset_after and self._bad_used
                            and self._progress_since_bad
                            >= self.bad_step_reset_after):
                        log.info("%d healthy new steps since the last bad "
                                 "one: recovery budget reset",
                                 self._progress_since_bad)
                        self._bad_used = 0
                if span is not None:
                    self.tracer.end(span, "ok", loss=lossf)
                handler(E.EndIteration(pass_id, batch_id, cost=loss,
                                       metrics=metrics))
                gidx += 1
                if cadence and (batch_id + 1) % cadence == 0:
                    self._save(state)
                self._pet()
                self._maybe_drain(state)
            if began:
                self._save(state)
                handler(E.EndPass(pass_id))
        return state


def run_resilient(model, loss_fn, optimizer, batch_iter_factory, *,
                  input_spec, checkpoint_dir: str, num_passes: int = 1,
                  metrics_fn=None, num_inputs: int = 1, seed: int = 0,
                  event_handler=None, device=None,
                  **resilience_kwargs) -> TrainState:
    """One-call fault-tolerant training: build the Trainer (on `device`,
    None -> cuda), init (or restore) the state, and drive it through
    `ResilientTrainer.run`. Raises `Preempted` after the drain save;
    rerunning the same call resumes."""
    trainer = Trainer(model, loss_fn, optimizer, metrics_fn=metrics_fn,
                      num_inputs=num_inputs, seed=seed, device=device)
    state = trainer.init_state(input_spec)
    rt = ResilientTrainer(trainer, checkpoint_dir, **resilience_kwargs)
    return rt.run(state, batch_iter_factory, num_passes=num_passes,
                  event_handler=event_handler)
