"""The port's fault-tolerant runtime (`train.resilience` with the training
part of `testing.faults`) on a small LSTM classifier with a float weight
column (the loss is mean(w * CE), so a NaN-poisoned batch carries a real
NaN through the LSTM's forward and backward), mirroring the scenarios of
tests/test_resilience.py:

- preempted at batch k and resumed: bit for bit the uninterrupted run
  (a Dropout in the model: each step's generator is seeded from the
  trainer's seed and the global batch index, so a resumed step draws
  what the uninterrupted one drew);
- NaN under skip and under rollback, the budget spent with
  DivergenceError, the budget reset by new progress, LR backoff, loss
  spikes;
- the newest checkpoint corrupted: the restore falls back past it, and
  the replay overwrites it; every checkpoint unreadable: a loud failure;
  ManifestMismatchError re-raised;
- a checkpoint write error absorbed, the drain save retried;
- the watchdog firing its custom action;
- the same fault plans give JAX's ResilientTrainer and the port's the
  same sequence of event types and outcomes, and, with the obs seams
  on, the same step spans, flight events, dumps and metric values."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu import optim as joptim
from paddle_tpu.ops import losses as JL
from paddle_tpu.testing import FaultPlan as JFaultPlan
from paddle_tpu.train import Trainer as JTrainer
from paddle_tpu.train import events as JE
from paddle_tpu.train import resilience as JR
from paddle_tpu_torch.core.pytree import tree_leaves
from paddle_tpu_torch.nn import layers as TNL
from paddle_tpu_torch.nn import module as TNM
from paddle_tpu_torch.nn import recurrent as TNR
from paddle_tpu_torch.ops import losses as TL
from paddle_tpu_torch.optim import optimizers as TO
from paddle_tpu_torch.testing import FaultError, FaultPlan
from paddle_tpu_torch.train import events as TE
from paddle_tpu_torch.train.checkpoint import (CheckpointManager,
                                               ManifestMismatchError)
from paddle_tpu_torch.train.resilience import (DivergenceError, Preempted,
                                               ResilientTrainer, Watchdog,
                                               restore_with_fallback,
                                               run_resilient, step_seed)
from paddle_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.faults

VOCAB, HID, B, T = 30, 8, 4, 6


def _model(dropout=0.0):
    return TNM.Sequential(
        [TNL.Embedding(VOCAB, HID, name="emb"),
         TNR.LSTM(HID, name="lstm")]
        + ([TNL.Dropout(dropout, name="drop")] if dropout else [])
        + [TNL.Lambda(lambda x: x.mean(dim=1), name="pool",
                      out_spec_fn=lambda s: TNM.ShapeSpec(
                          (s.shape[0], s.shape[2]), s.dtype)),
           TNL.Dense(2, name="fc")])


def _loss(logits, labels, weights):
    return torch.mean(weights * TL.softmax_cross_entropy(logits, labels))


def _batches(n=6, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randint(0, VOCAB, (B, T)).astype(np.int32),
             r.randint(0, 2, B).astype(np.int64),
             np.ones(B, np.float32)) for _ in range(n)]


def _trainer(dropout=0.0, lr=0.1):
    return Trainer(_model(dropout), _loss, TO.adam(lr), seed=0,
                   device="cpu")


def _run(ckpt_dir, factory, *, num_passes=2, event_handler=None,
         dropout=0.0, **kw):
    """A fresh Trainer (same seed) + ResilientTrainer over `factory`: the
    restart-the-process idiom, minus the process."""
    tr = _trainer(dropout)
    state = tr.init_state(TNM.ShapeSpec((B, T), torch.int32))
    rt = ResilientTrainer(tr, str(ckpt_dir), **kw)
    return rt, rt.run(state, factory, num_passes=num_passes,
                      event_handler=event_handler)


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _finite(tree):
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree))


# -- preemption-safe resume ---------------------------------------------------


def test_preempt_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    batches = _batches()
    _, ref = _run(tmp_path / "ref", lambda: iter(batches), dropout=0.3,
                  checkpoint_every_n_batches=2)
    plan = FaultPlan(preempt_at=7)      # mid pass 1
    with pytest.raises(Preempted) as ei:
        _run(tmp_path / "pre", plan.wrap_batches(lambda: iter(batches)),
             dropout=0.3, checkpoint_every_n_batches=2)
    assert plan.count("preempt") == 1
    assert ei.value.step == 7           # drained exactly at the boundary
    rt, resumed = _run(tmp_path / "pre", lambda: iter(batches), dropout=0.3,
                       checkpoint_every_n_batches=2)
    assert rt.restored_step == 7
    assert int(resumed.step) == int(ref.step) == 12
    _same(resumed.params, ref.params)
    _same(resumed.opt_state, ref.opt_state)


def test_step_seed_is_a_fixed_mix():
    assert step_seed(0, 5) == step_seed(0, 5)
    seeds = {step_seed(s, g) for s in range(3) for g in range(50)}
    assert len(seeds) == 150
    assert all(0 <= s < 2 ** 64 for s in seeds)


def test_run_resilient_preempt_restart_roundtrip(tmp_path):
    batches = _batches()
    kw = dict(input_spec=TNM.ShapeSpec((B, T), torch.int32),
              checkpoint_dir=str(tmp_path / "rr"), num_passes=2,
              device="cpu", checkpoint_every_n_batches=3)
    ref = run_resilient(_model(0.3), _loss, TO.adam(0.1),
                        lambda: iter(batches),
                        **{**kw, "checkpoint_dir": str(tmp_path / "ref")})
    plan = FaultPlan(preempt_at=4)
    with pytest.raises(Preempted):
        run_resilient(_model(0.3), _loss, TO.adam(0.1),
                      plan.wrap_batches(lambda: iter(batches)), **kw)
    out = run_resilient(_model(0.3), _loss, TO.adam(0.1),
                        lambda: iter(batches), **kw)
    _same(out.params, ref.params)


def test_resume_without_faults_is_a_noop(tmp_path):
    batches = _batches()
    _, first = _run(tmp_path / "d", lambda: iter(batches))
    rt, again = _run(tmp_path / "d", lambda: iter(batches))
    assert rt.restored_step == int(first.step) == 12
    _same(again.params, first.params)


# -- the divergence guard -----------------------------------------------------


def test_nan_step_rollback_repairs_the_update(tmp_path):
    batches = _batches()
    _, ref = _run(tmp_path / "ref", lambda: iter(batches),
                  checkpoint_every_n_batches=1)
    plan = FaultPlan(nan_batch_at=3)
    rt, out = _run(tmp_path / "nan", plan.wrap_batches(lambda: iter(batches)),
                   checkpoint_every_n_batches=1, bad_step_policy="rollback")
    assert plan.count("nan") == 1
    assert [(b.step, b.action, b.reason) for b in rt.bad_steps] == [
        (3, "rollback", "non-finite loss")]
    assert int(out.step) == int(ref.step)
    _same(out.params, ref.params)


def test_nan_step_skip_equals_a_clean_run_without_that_batch(tmp_path):
    """skip discards the poisoned update and advances the step: the
    parameters equal, bit for bit, a clean run over the same batches
    without batch k, each batch at the step index the skip run gave it
    (the skipped batch still ticks the step, and with it adam's bias
    correction)."""
    batches = _batches()
    plan = FaultPlan(nan_batch_at=2)
    rt, out = _run(tmp_path / "skip", plan.wrap_batches(lambda: iter(batches)),
                   num_passes=1, bad_step_policy="skip")
    assert [(b.step, b.action) for b in rt.bad_steps] == [(2, "skip")]
    assert int(out.step) == 6 and _finite(out.params)
    # the clean run: the same trainer steps over the batches without k,
    # each at the step index the skip run gave it
    tr = _trainer()
    state = tr.init_state(TNM.ShapeSpec((B, T), torch.int32))
    step = tr._train_step
    gen = torch.Generator()
    for gidx, batch in enumerate(batches):
        if gidx == 2:
            state = state._replace(step=state.step + 1)
            continue
        gen.manual_seed(step_seed(tr.seed, gidx))
        state, _, _ = step(state, gen, *tr._split_batch(batch))
    _same(out.params, state.params)
    _same(out.opt_state, state.opt_state)


def test_skip_then_preempt_resume_is_exact(tmp_path):
    batches = _batches()
    plan_a = FaultPlan(nan_batch_at=2)
    _, ref = _run(tmp_path / "a", plan_a.wrap_batches(lambda: iter(batches)),
                  bad_step_policy="skip", checkpoint_every_n_batches=2)
    plan_b = FaultPlan(nan_batch_at=2, preempt_at=7)
    with pytest.raises(Preempted) as ei:
        _run(tmp_path / "b", plan_b.wrap_batches(lambda: iter(batches)),
             bad_step_policy="skip", checkpoint_every_n_batches=2)
    assert ei.value.step == 7
    _, out = _run(tmp_path / "b", lambda: iter(batches),
                  bad_step_policy="skip", checkpoint_every_n_batches=2)
    assert int(out.step) == int(ref.step) == 12
    _same(out.params, ref.params)


def test_divergence_budget_hard_fails(tmp_path):
    nan_batches = [(x, y, np.full_like(w, np.nan))
                   for x, y, w in _batches()]
    with pytest.raises(DivergenceError) as ei:
        _run(tmp_path / "div", lambda: iter(nan_batches), max_bad_steps=2,
             bad_step_policy="skip")
    assert len(ei.value.bad_steps) == 3
    assert ei.value.bad_steps[-1].action == "fail"


def test_bad_step_budget_resets_on_new_progress(tmp_path):
    poisoned = _batches(n=12)
    for i in (2, 9):
        x, y, w = poisoned[i]
        poisoned[i] = (x, y, np.full_like(w, np.nan))
    rt, out = _run(tmp_path / "reset", lambda: iter(poisoned), num_passes=1,
                   bad_step_policy="skip", max_bad_steps=1,
                   bad_step_reset_after=3)
    assert len(rt.bad_steps) == 2 and int(out.step) == 12
    assert rt.counters()["bad_steps"] == 2
    with pytest.raises(DivergenceError):
        _run(tmp_path / "noreset", lambda: iter(poisoned), num_passes=1,
             bad_step_policy="skip", max_bad_steps=1,
             bad_step_reset_after=None)


def test_rollback_with_lr_backoff(tmp_path):
    plan = FaultPlan(nan_batch_at=2)
    rt, out = _run(tmp_path / "bo", plan.wrap_batches(lambda: iter(_batches())),
                   checkpoint_every_n_batches=1, bad_step_policy="rollback",
                   lr_backoff=0.5)
    assert rt._lr_scale == 0.5 and rt.counters()["lr_scale"] == 0.5
    assert [b.action for b in rt.bad_steps] == ["rollback"]
    assert int(out.step) == 12 and _finite(out.params)


def test_loss_spike_detection(tmp_path):
    spiked = _batches()
    x, y, w = spiked[4]
    spiked[4] = (x, y, w * 1e6)         # finite, huge loss
    rt, out = _run(tmp_path / "spike", lambda: iter(spiked),
                   bad_step_policy="skip", loss_spike_factor=100.0)
    assert any("spike" in b.reason for b in rt.bad_steps)
    assert int(out.step) == 12 and _finite(out.params)


def test_bad_policy_and_backoff_are_checked(tmp_path):
    tr = _trainer()
    with pytest.raises(ValueError, match="skip|rollback"):
        ResilientTrainer(tr, str(tmp_path), bad_step_policy="retry")
    with pytest.raises(ValueError, match="lr_backoff"):
        ResilientTrainer(tr, str(tmp_path), lr_backoff=1.5)


@pytest.mark.parametrize("seam", ["tracer", "flight", "pserver_client",
                                  "step_builder"])
def test_unported_seams_raise(tmp_path, seam):
    """Every seam is ported now. The obs seams (tracer, flight) bind to a
    registry (their parity with JAX: test_obs_seams_match_jax);
    step_builder makes the step from the trainer's optimizer (the ZeRO
    step in tests/test_torch_elastic.py); pserver_client binds the
    client's exactly-once ledger under {prefix}_pserver (the run through
    a shard kill: tests/test_torch_pserver.py)."""
    from paddle_tpu_torch.native.pserver import ShardSpec
    from paddle_tpu_torch.obs import FlightRecorder, MetricsRegistry, Tracer
    from paddle_tpu_torch.parallel.pserver_client import PServerClient

    if seam == "step_builder":
        built = []
        tr = _trainer()
        rt = ResilientTrainer(tr, str(tmp_path), step_builder=lambda opt: (
            built.append(opt) or "the step"))
        assert built == [tr.optimizer] and rt._step == "the step"
        return

    if seam in ("tracer", "flight"):
        obj = Tracer() if seam == "tracer" else FlightRecorder()
        rt = ResilientTrainer(_trainer(), str(tmp_path), **{seam: obj})
        reg = MetricsRegistry()
        rt.bind_metrics(reg)
        names = {r["name"] for r in reg.snapshot()["series"]}
        part = "trace" if seam == "tracer" else "flight"
        assert "train_bad_steps" in names
        assert any(n.startswith(f"train_{part}_") for n in names)
        return
    client = PServerClient([ShardSpec(0, 0, 8, [("127.0.0.1", 1)])], 4)
    rt = ResilientTrainer(_trainer(), str(tmp_path), pserver_client=client)
    assert rt.pserver_client is client
    reg = MetricsRegistry()
    rt.bind_metrics(reg)
    names = {r["name"] for r in reg.snapshot()["series"]}
    assert {"train_pserver_pushes", "train_pserver_duplicate_acks",
            "train_pserver_reregistrations"} <= names


# -- checkpoints -------------------------------------------------------------


def _corrupt(step_dir):
    with open(os.path.join(step_dir, "state.pt"), "wb") as f:
        f.write(b"torn write")


def test_corrupt_newest_checkpoint_falls_back_and_is_overwritten(tmp_path):
    batches = _batches()
    _, ref = _run(tmp_path / "c", lambda: iter(batches), num_passes=1,
                  checkpoint_every_n_batches=2)
    final = int(ref.step)
    _corrupt(os.path.join(str(tmp_path / "c"), str(final)))
    rt2, out = _run(tmp_path / "c", lambda: iter(batches), num_passes=1,
                    checkpoint_every_n_batches=2)
    assert rt2.restored_step == final - 2          # fell back past it
    # the replay's final save overwrote the corrupt step
    assert rt2.counters()["corrupt_steps"] == 0
    _same(out.params, ref.params)
    # the replayed final step is durable again: restored directly
    tr = _trainer()
    template = tr.init_state(TNM.ShapeSpec((B, T), torch.int32))
    bad = []
    restored, step = restore_with_fallback(
        CheckpointManager(str(tmp_path / "c")), template, bad_steps=bad)
    assert step == final and bad == []
    _same(restored.params, ref.params)


def test_all_checkpoints_unrestorable_fails_loudly(tmp_path):
    _run(tmp_path / "d", lambda: iter(_batches()))
    other = TNM.Sequential([TNL.Embedding(VOCAB, 5, name="emb"),
                            TNL.Lambda(lambda x: x.mean(dim=1), name="pool",
                                       out_spec_fn=lambda s: TNM.ShapeSpec(
                                           (s.shape[0], s.shape[2]))),
                            TNL.Dense(2, name="fc")])
    tr = Trainer(other, _loss, TO.adam(0.1), device="cpu")
    rt = ResilientTrainer(tr, str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="none is restorable"):
        rt.run(tr.init_state(TNM.ShapeSpec((B, T), torch.int32)),
               lambda: iter(_batches()), num_passes=1)


class _MismatchedManager(CheckpointManager):
    """A manager whose manifest never matches the template."""

    def restore(self, template, step=None):
        raise ManifestMismatchError(f"step {step}: param tree hash differs")


def test_manifest_mismatch_is_reraised_not_walked_back(tmp_path):
    _run(tmp_path / "m", lambda: iter(_batches()), num_passes=1,
         checkpoint_every_n_batches=2)
    mgr = _MismatchedManager(str(tmp_path / "m"))
    assert len(mgr.all_steps()) == 3
    tr = _trainer()
    rt = ResilientTrainer(tr, str(tmp_path / "m"), checkpoint_manager=mgr)
    bad = []
    with pytest.raises(ManifestMismatchError, match="hash differs"):
        restore_with_fallback(mgr, None, bad_steps=bad)
    assert bad == []
    with pytest.raises(ManifestMismatchError):
        rt.run(tr.init_state(TNM.ShapeSpec((B, T), torch.int32)),
               lambda: iter(_batches()))


def test_checkpoint_write_failure_is_absorbed(tmp_path):
    tr = _trainer()
    state = tr.init_state(TNM.ShapeSpec((B, T), torch.int32))
    plan = FaultPlan(checkpoint_error_at=1)
    mgr = plan.wrap_checkpoint_manager(
        CheckpointManager(str(tmp_path / "c"), max_to_keep=3))
    rt = ResilientTrainer(tr, str(tmp_path / "c"),
                          checkpoint_every_n_batches=2,
                          checkpoint_manager=mgr)
    out = rt.run(state, lambda: iter(_batches()), num_passes=2)
    assert plan.count("ckpt") == 1 and len(rt.save_errors) == 1
    assert "injected checkpoint-write failure" in rt.save_errors[0]
    assert int(out.step) == 12 and mgr.latest_step() == 12


def test_drain_save_retries_through_oserror(tmp_path):
    tr = _trainer()
    state = tr.init_state(TNM.ShapeSpec((B, T), torch.int32))
    plan = FaultPlan(checkpoint_error_at=1, preempt_at=3)
    mgr = plan.wrap_checkpoint_manager(CheckpointManager(str(tmp_path / "c")))
    rt = ResilientTrainer(tr, str(tmp_path / "c"), checkpoint_manager=mgr)
    with pytest.raises(Preempted) as ei:
        rt.run(state, plan.wrap_batches(lambda: iter(_batches())),
               num_passes=2)
    assert ei.value.step == 3 and plan.count("ckpt") == 1
    assert mgr.latest_step() == 3


# -- the watchdog --------------------------------------------------------------


def test_watchdog_fires_its_custom_action_on_a_stall():
    fired = []
    wd = Watchdog(0.2, lambda elapsed: fired.append(elapsed), poll_s=0.02)
    wd.start()
    try:
        deadline = time.time() + 5
        while not fired and time.time() < deadline:
            time.sleep(0.02)
    finally:
        wd.stop()
    assert wd.fired and fired and fired[0] >= 0.2


def test_watchdog_petting_prevents_fire_and_the_loop_pets_it(tmp_path):
    fired = []
    with Watchdog(0.3, lambda e: fired.append(e), poll_s=0.02) as wd:
        for _ in range(10):
            time.sleep(0.05)
            wd.pet()
    assert not fired and not wd.fired
    rt, out = _run(tmp_path / "wd", lambda: iter(_batches()),
                   watchdog_timeout_s=30.0,
                   watchdog_on_timeout=lambda e: fired.append(e))
    assert int(out.step) == 12 and not fired
    with pytest.raises(ValueError):
        Watchdog(0.0)


def test_reader_faults_fire_once_and_lose_nothing():
    plan = FaultPlan(reader_error_at=3)
    reader = plan.wrap_reader(lambda: iter(range(6)))
    with pytest.raises(FaultError, match="sample 3"):
        list(reader())
    assert list(reader()) == list(range(6))
    rate = FaultPlan(seed=1, reader_error_rate=0.5)
    with pytest.raises(FaultError):
        list(rate.wrap_reader(lambda: iter(range(50)))())
    assert rate.count("reader") == 1


# -- the same faults, the same events as JAX's ResilientTrainer ----------------


def _jax_model():
    return jnn.Sequential([
        jnn.Embedding(VOCAB, HID, name="emb"), jnn.LSTM(HID, name="lstm"),
        jnn.Lambda(lambda x: x.mean(axis=1), name="pool",
                   out_spec_fn=lambda s: jnn.ShapeSpec(
                       (s.shape[0], s.shape[2]), s.dtype)),
        jnn.Dense(2, name="fc")])


def _jloss(logits, labels, weights):
    return jnp.mean(weights * JL.softmax_cross_entropy(logits, labels))


@pytest.fixture(scope="module")
def jax_ready(tmp_path_factory):
    """JAX's backend, its first jit and its (orbax) checkpoint manager
    warmed up before the parity tests time their own runs."""
    from paddle_tpu.train.checkpoint import CheckpointManager as JCM
    from paddle_tpu.train.state import TrainState as JTS

    jax.jit(lambda a: a + 1)(jnp.zeros(2)).block_until_ready()
    mgr = JCM(str(tmp_path_factory.mktemp("warm")))
    mgr.save(JTS(params={"w": jnp.zeros(2)}, model_state={}, opt_state={},
                 step=jnp.zeros((), jnp.int32)))
    mgr.all_steps()
    mgr.close()


def _events(E, kinds):
    def h(ev):
        name = type(ev).__name__
        if isinstance(ev, E.EndIteration):
            name += f":{ev.pass_id}:{ev.batch_id}:{ev.outcome}"
        elif hasattr(ev, "pass_id"):
            name += f":{ev.pass_id}"
        kinds.append(name)
    return h


@pytest.mark.parametrize("scenario", [
    dict(plan=dict(nan_batch_at=2), kw=dict(bad_step_policy="skip")),
    dict(plan=dict(nan_batch_at=3),
         kw=dict(bad_step_policy="rollback", lr_backoff=0.5,
                 checkpoint_every_n_batches=2)),
    dict(plan=dict(nan_batch_at=1, once=False),
         kw=dict(bad_step_policy="skip", max_bad_steps=1)),
    dict(plan=dict(preempt_at=4), kw=dict(checkpoint_every_n_batches=2)),
], ids=["skip", "rollback_backoff", "budget_spent", "preempt"])
def test_the_same_fault_plan_gives_jax_events_and_outcomes(tmp_path,
                                                           scenario,
                                                           jax_ready):
    batches = _batches()
    results = []
    for side in ("jax", "torch"):
        kinds = []
        if side == "jax":
            plan = JFaultPlan(**scenario["plan"])
            tr = JTrainer(_jax_model(), _jloss, joptim.adam(0.1), seed=0,
                          num_inputs=1)
            state = tr.init_state(jnn.ShapeSpec((B, T), jnp.int32))
            rt = JR.ResilientTrainer(tr, str(tmp_path / side),
                                     **scenario["kw"])
            errors = (JR.Preempted, JR.DivergenceError)
            E = JE
        else:
            plan = FaultPlan(**scenario["plan"])
            tr = _trainer()
            state = tr.init_state(TNM.ShapeSpec((B, T), torch.int32))
            rt = ResilientTrainer(tr, str(tmp_path / side), **scenario["kw"])
            errors = (Preempted, DivergenceError)
            E = TE
        outcome = "done"
        try:
            rt.run(state, plan.wrap_batches(lambda: iter(batches)),
                   num_passes=2, event_handler=_events(E, kinds))
        except errors as e:
            outcome = type(e).__name__
        results.append((kinds, outcome, plan.fired,
                        [(b.step, b.pass_id, b.batch_id, b.reason, b.action)
                         for b in rt.bad_steps],
                        rt.restored_step, rt.counters()["save_errors"]))
    assert results[0] == results[1]


@pytest.mark.parametrize("scenario", [
    dict(plan=dict(nan_batch_at=3),
         kw=dict(bad_step_policy="rollback", lr_backoff=0.5,
                 checkpoint_every_n_batches=2)),
    dict(plan=dict(nan_batch_at=1, once=False),
         kw=dict(bad_step_policy="skip", max_bad_steps=1)),
    dict(plan=dict(preempt_at=4), kw=dict(checkpoint_every_n_batches=2)),
], ids=["rollback_backoff", "budget_spent", "preempt"])
def test_obs_seams_match_jax(tmp_path, scenario, jax_ready):
    """One scripted fault run per scenario on both trainers with a
    tracer, a flight recorder (dumping to its own directory) and a
    metrics registry: equal span ids and outcomes, flight events, dump
    reasons and metric values."""
    from paddle_tpu import obs as jobs
    from paddle_tpu_torch import obs as tobs

    batches = _batches()
    results = []
    for side in ("jax", "torch"):
        obs = jobs if side == "jax" else tobs
        clk = lambda: 7.0
        flight = obs.FlightRecorder(clock=clk)
        tracer = obs.Tracer(clock=clk, sink=flight.note_span)
        registry = obs.MetricsRegistry(clock=clk)
        fdir = tmp_path / f"flight_{side}"
        fdir.mkdir()
        obs_kw = dict(tracer=tracer, flight=flight, flight_dir=str(fdir))
        if side == "jax":
            plan = JFaultPlan(**scenario["plan"])
            tr = JTrainer(_jax_model(), _jloss, joptim.adam(0.1), seed=0,
                          num_inputs=1)
            state = tr.init_state(jnn.ShapeSpec((B, T), jnp.int32))
            rt = JR.ResilientTrainer(tr, str(tmp_path / side),
                                     **scenario["kw"], **obs_kw)
            errors = (JR.Preempted, JR.DivergenceError)
        else:
            plan = FaultPlan(**scenario["plan"])
            tr = _trainer()
            state = tr.init_state(TNM.ShapeSpec((B, T), torch.int32))
            rt = ResilientTrainer(tr, str(tmp_path / side),
                                  **scenario["kw"], **obs_kw)
            errors = (Preempted, DivergenceError)
        rt.bind_metrics(registry)
        try:
            rt.run(state, plan.wrap_batches(lambda: iter(batches)),
                   num_passes=2)
        except errors:
            pass
        dumps = sorted(os.listdir(fdir))
        reasons = []
        for d in dumps:
            with open(fdir / d) as f:
                reasons.append(json.load(f)["reason"])
        series = {r["name"]: r["value"]
                  for r in registry.snapshot()["series"]}
        results.append(dict(
            spans=[(sp.trace_id, sp.outcome) for sp in tracer.finished],
            trace=tracer.counters(),
            events=[(e["kind"], e.get("name"), e.get("step"),
                     e.get("action")) for e in flight.events()],
            reasons=reasons, series=series))
    assert results[1] == results[0]
    assert results[1]["spans"] and results[1]["events"]
