"""Deterministic, seed-driven fault injection for training and serving
(port of `paddle_tpu.testing.faults`).

`FaultPlan` is one switchboard: a test declares WHERE faults strike
(sample index, global batch index, nth checkpoint save) and wraps the
real component; every fault fires deterministically (once by default),
is recorded in `plan.fired`, and the wrapped component otherwise
behaves as before -- so a passing recovery test means the recovery path
ran, not that the fault missed. The faults:

- reader exceptions at sample k, or at a seeded random rate
  (`wrap_reader`);
- an all-NaN batch at global batch k (`wrap_batches`): every float
  column of the batch is NaN, so the NaN flows through forward and
  backward into the loss AND the gradients;
- a preemption: `preempt_signal` (SIGTERM) sent to this process right
  before batch k is consumed (`wrap_batches`);
- an OSError on the nth checkpoint save (`wrap_checkpoint_manager`);
- serving faults on an engine (`wrap_engine`: the nth prefill or decode
  step raises, a burst of the first N calls raises, a decode step
  stalls a `ManualClock`) and on its page pool (`wrap_page_pool`: an
  allocation reports exhaustion, a prefix-cache hit is corrupted);
- router faults (`wrap_replica_engine`: a replica dies at its nth decode
  step or mid KV import, or every decode skews the clock; `wrap_probe`:
  blackholed health probes) and data-plane faults (`wrap_arena`);
- training gang faults on a `parallel.launch.GangSupervisor`
  (`wrap_gang`): a real SIGKILL (`gang_kill_step_at`/`gang_kill_rank`)
  or SIGSTOP (`gang_wedge_step_at`/`gang_wedge_rank`) of a member once
  its heartbeat reports the step;
- a master-connection drop before the nth `MasterClient` RPC
  (`wrap_master_client`);
- parameter-server faults on a `native.pserver.PServerShard`
  (`wrap_pserver_shard`): the shard killed on the nth push or get_rows,
  a lost ACK, a slow replica, a snapshot-write error;
- a streaming trainer's death at its nth step (`wrap_online_trainer`);
- process faults on a `serve.fleet.FleetSupervisor` (`wrap_fleet`): a
  real SIGKILL of one replica child (`fleet_sigkill_at`/
  `fleet_sigkill_replica`) right before the nth sweep;
- host faults on a membership-mode supervisor (`wrap_cluster`): a real
  SIGKILL of one per-host agent (`cluster_sigkill_at`/
  `cluster_sigkill_host`), its lease expired on the membership
  service's `ManualClock`;
- `build_chaos_replica`, the spawn-importable replica builder whose
  child arms data-plane faults on its own arena handle.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch


class FaultError(RuntimeError):
    """The exception injected faults raise: distinct from real errors, so
    tests can assert the failure they caused is the one handled."""


@dataclasses.dataclass
class FaultPlan:
    """Declarative fault schedule. All indices are 0-based; `once=True`
    (default) makes each fault fire a single time -- the recovery path
    must then succeed against an otherwise healthy component."""

    seed: int = 0
    reader_error_at: Optional[int] = None     # sample index
    reader_error_rate: float = 0.0            # seeded per-sample chance
    nan_batch_at: Optional[int] = None        # global batch index
    preempt_at: Optional[int] = None          # global batch index
    preempt_signal: int = signal.SIGTERM
    checkpoint_error_at: Optional[int] = None  # nth save() call
    master_drop_at: Optional[int] = None      # nth MasterClient RPC
    # -- serving faults (serve.server, via wrap_engine) --
    serve_prefill_error_at: Optional[int] = None  # nth prefill call
    serve_decode_error_at: Optional[int] = None   # nth decode_step call
    serve_error_first_n: Optional[int] = None     # first N engine calls
    serve_stall_at: Optional[int] = None          # nth decode_step
    serve_stall_s: float = 0.0                    # clock burned per stall
    serve_page_alloc_error_at: Optional[int] = None  # nth page alloc
    serve_prefix_corrupt_at: Optional[int] = None    # nth cache lookup
    # -- router faults (serve.router, via wrap_replica_engine) --
    router_kill_decode_at: Optional[int] = None   # nth decode on wrapped
    router_kill_import_at: Optional[int] = None   # nth KV-block import
    router_probe_drop_first_n: Optional[int] = None  # blackholed probes
    router_slow_decode_s: float = 0.0             # clock skew per decode
    # -- fleet process faults (serve.fleet, via wrap_fleet) --
    fleet_sigkill_at: Optional[int] = None        # nth supervisor sweep
    fleet_sigkill_replica: int = 0                # rid of the victim child
    # -- cluster faults (cluster.agent + membership, via wrap_cluster) --
    cluster_sigkill_at: Optional[int] = None      # nth supervisor sweep
    cluster_sigkill_host: str = ""                # host_id of the victim
    # -- data-plane faults (serve.shm_arena, via wrap_arena) --
    arena_kill_scatter_at: Optional[int] = None   # nth segment written
    arena_kill_adopt_at: Optional[int] = None     # nth segment adopted
    arena_error_at: Optional[int] = None          # nth scatter() call
    # -- training gang faults (parallel.launch, via wrap_gang) --
    gang_kill_step_at: Optional[int] = None       # victim heartbeat step
    gang_kill_rank: int = 1                       # rank of the victim
    gang_wedge_step_at: Optional[int] = None      # SIGSTOP, not SIGKILL
    gang_wedge_rank: int = 1                      # rank of the victim
    # -- parameter-server faults (native.pserver, via wrap_pserver_shard) --
    pserver_kill_push_at: Optional[int] = None    # nth push received
    pserver_kill_get_at: Optional[int] = None     # nth get_rows received
    pserver_lost_ack_at: Optional[int] = None     # nth push ACK dropped
    pserver_replica_delay_at: Optional[int] = None  # nth repl record
    pserver_replica_delay_s: float = 0.0          # stall per delayed record
    pserver_snapshot_error_at: Optional[int] = None  # nth snapshot write
    # -- online-learning faults (train.online, via wrap_online_trainer) --
    online_kill_step_at: Optional[int] = None     # nth streaming step
    once: bool = True
    fired: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._batch_counter = 0
        self._save_counter = 0
        self._call_counter = 0
        self._serve_prefill_counter = 0
        self._serve_decode_counter = 0
        self._serve_call_counter = 0
        self._page_alloc_counter = 0
        self._prefix_lookup_counter = 0
        self._router_decode_counter = 0
        self._router_import_counter = 0
        self._router_probe_counter = 0
        self._fleet_sweep_counter = 0
        self._cluster_sweep_counter = 0
        self._arena_scatter_counter = 0
        self._arena_adopt_counter = 0
        self._arena_begin_counter = 0
        self._pserver_push_counter = 0
        self._pserver_get_counter = 0
        self._pserver_ack_counter = 0
        self._pserver_repl_counter = 0
        self._pserver_snap_counter = 0
        self._online_step_counter = 0

    # -- bookkeeping ------------------------------------------------------

    def _note(self, kind: str, detail: Any) -> None:
        self.fired.append(f"{kind}@{detail}")

    def count(self, kind: str) -> int:
        return sum(1 for f in self.fired if f.startswith(f"{kind}@"))

    def _spent(self, kind: str) -> bool:
        return self.once and self.count(kind) > 0

    # -- reader faults ----------------------------------------------------

    def wrap_reader(self, reader: Callable) -> Callable:
        """Wrap a data.reader-style reader (zero-arg callable returning
        an iterator): raises FaultError at sample `reader_error_at`
        and/or at a seeded `reader_error_rate` per sample. The faulted
        sample is NOT consumed from the inner reader -- a retried stream
        sees it again (no silent loss)."""
        plan = self

        def new_reader():
            for i, item in enumerate(reader()):
                hit = (plan.reader_error_at == i
                       and not plan._spent("reader"))
                if not hit and plan.reader_error_rate > 0:
                    hit = (plan._rng.random() < plan.reader_error_rate
                           and not plan._spent("reader"))
                if hit:
                    plan._note("reader", i)
                    raise FaultError(f"injected reader fault at "
                                     f"sample {i}")
                yield item

        return new_reader

    # -- batch-level faults (NaN poisoning, preemption) -------------------

    def wrap_batches(self, batch_iter_factory: Callable) -> Callable:
        """Wrap a batch_iter_factory (what Trainer/ResilientTrainer
        consume). The batch counter is GLOBAL across factory calls, so
        `nan_batch_at`/`preempt_at` address the run's global batch index
        across passes and rollback replays (a replayed index is poisoned
        again only with once=False)."""
        plan = self

        def factory():
            for batch in batch_iter_factory():
                idx = plan._batch_counter
                plan._batch_counter += 1
                if idx == plan.preempt_at and not plan._spent("preempt"):
                    plan._note("preempt", idx)
                    os.kill(os.getpid(), plan.preempt_signal)
                if idx == plan.nan_batch_at and not plan._spent("nan"):
                    plan._note("nan", idx)
                    batch = _poison_batch(batch)
                yield batch

        return factory

    # -- checkpoint faults ------------------------------------------------

    def wrap_checkpoint_manager(self, manager) -> "_FlakyCheckpoints":
        return _FlakyCheckpoints(manager, self)

    # -- serving faults (engine-level) ------------------------------------

    def wrap_engine(self, engine, clock: Optional["ManualClock"] = None):
        """Wrap a serve.DecodeEngine (or anything with prefill /
        decode_step) so serving faults fire deterministically:

        - `serve_prefill_error_at` / `serve_decode_error_at`: the nth
          prefill / decode_step call raises FaultError BEFORE touching
          the engine — a transient device/native fault at a precise
          point in the schedule (the state the caller holds stays
          valid, which is exactly the contract a retry path must rely
          on);
        - `serve_error_first_n`: the first N calls (prefill and decode
          combined) ALL raise — the repeated-failure shape that must
          trip a circuit breaker, after which the engine is healthy
          again so recovery is provable;
        - `serve_stall_at` (+ `serve_stall_s`): the nth decode step
          advances `clock` by `serve_stall_s` before running — a slot
          stall that burns request deadlines with no wall-clock sleep
          (pass the same ManualClock the server schedules with).

        Everything else delegates, so a wrapped engine is otherwise
        bit-identical to the real one."""
        return _FaultyEngine(engine, self, clock)

    def wrap_page_pool(self, pool):
        """Install this plan on a `serve.paged.PagePool` via its
        `fault_hook` seam. Fault points:

        - "alloc": the `serve_page_alloc_error_at`-th allocation call
          (admissions AND mid-decode extends, plan-global) reports
          exhaustion — the pool raises PoolExhaustedError exactly as
          if the arena were full, so the server's shed/requeue and the
          engine's preempt paths run against a provably healthy pool;
        - "lookup": the `serve_prefix_corrupt_at`-th prefix-cache hit
          has its stored block tokens FLIPPED before the pool
          re-verifies them — the corruption-defense path (treat as
          miss, evict, count prefix_rejected) must fire and greedy
          parity must survive."""
        plan = self

        def hook(event: str, ctx=None):
            if event == "alloc":
                idx = plan._page_alloc_counter
                plan._page_alloc_counter += 1
                if (idx == plan.serve_page_alloc_error_at
                        and not plan._spent("pagealloc")):
                    plan._note("pagealloc", idx)
                    return True        # pool raises PoolExhaustedError
            elif event == "lookup":
                idx = plan._prefix_lookup_counter
                plan._prefix_lookup_counter += 1
                if (idx == plan.serve_prefix_corrupt_at
                        and not plan._spent("prefixcorrupt")):
                    plan._note("prefixcorrupt", idx)
                    # flip the stored tokens in place: verification
                    # against the real prompt block must now fail
                    ctx.tokens = tuple(t ^ 1 for t in ctx.tokens)
            return None

        pool.fault_hook = hook
        return pool

    # -- router / fleet faults --------------------------------------------

    def wrap_replica_engine(self, engine,
                            clock: Optional["ManualClock"] = None):
        """Wrap one replica's DecodeEngine with fleet-level faults:

        - `router_kill_decode_at`: the nth decode_step across ALL
          engines wrapped by this plan (wrap one engine for an exact
          per-replica index) raises `serve.router.ReplicaDeadError` —
          and the wrapper is DEAD from then on: every later prefill/
          decode/init raises too, exactly like a lost device. The
          fault is the replica-fatal shape `ServingServer.step()`
          re-raises with its host ledger intact, so the router's
          harvest-and-redistribute path runs against the real
          contract;
        - `router_slow_decode_s` (+ ManualClock): EVERY decode step on
          this replica advances `clock` first — a persistently slow
          replica skews deadlines for its own requests without one
          wall-clock sleep;
        - `router_kill_import_at`: the nth `import_slot_kv` call (a
          KV-block migration landing on this replica) raises
          ReplicaDeadError MID-TRANSFER and the replica stays dead —
          the shape the disaggregated fleet's refcount discipline
          must survive without losing or double-serving the request.

        Everything else delegates, so an unkilled wrapped replica is
        bit-identical to the real engine."""
        return _DoomedReplicaEngine(engine, self, clock)

    def wrap_probe(self, replica):
        """Blackhole the replica's health checks: the first
        `router_probe_drop_first_n` probe calls (plan-global counter)
        raise FaultError while the replica itself keeps serving —
        the router's breaker must open on consecutive probe failures
        (routing stops) and the first clean probe must close it
        (routing resumes)."""
        plan = self

        def hook(rep):
            idx = plan._router_probe_counter
            plan._router_probe_counter += 1
            if (plan.router_probe_drop_first_n is not None
                    and idx < plan.router_probe_drop_first_n):
                plan._note("probedrop", idx)
                raise FaultError(
                    f"injected health-probe blackhole #{idx}")

        replica.probe_hook = hook
        return replica

    def wrap_fleet(self, supervisor):
        """Install a REAL process kill on a `serve.fleet`
        FleetSupervisor: right before the `fleet_sigkill_at`-th
        supervisor sweep, the child process of replica
        `fleet_sigkill_replica` gets SIGKILL -- no drain, no goodbye
        frame, its sockets, its CUDA context and its in-flight decode
        state die with the address space (`join` makes the death
        visible before the sweep runs, so the fault is deterministic
        rather than racing the scheduler). The sweep must then discover
        the corpse through the transport (connect failures / a dead
        `proc.alive()`), harvest the router-side mirror ledger, and
        redistribute with exactly-once outcomes."""
        plan = self

        inner_sweep = supervisor.sweep

        def sweep():
            idx = plan._fleet_sweep_counter
            plan._fleet_sweep_counter += 1
            if (idx == plan.fleet_sigkill_at
                    and not plan._spent("fleetkill")):
                proc = supervisor.procs.get(plan.fleet_sigkill_replica)
                if proc is not None and proc.alive():
                    plan._note("fleetkill", idx)
                    os.kill(proc.pid, signal.SIGKILL)
                    proc.proc.join(10.0)
            return inner_sweep()

        supervisor.sweep = sweep
        return supervisor

    def wrap_cluster(self, supervisor, agents, *, clock, service,
                     settle_timeout_s: float = 30.0):
        """Install a REAL host death on a membership-mode
        `FleetSupervisor`: right before the `cluster_sigkill_at`-th
        sweep, the agent of host `cluster_sigkill_host` (from `agents`,
        a host_id -> AgentProcess map) gets SIGKILL -- its replica
        grandchildren die with it on the watchdog chain, and nothing
        deregisters. The membership service's injected `ManualClock`
        then advances in TWO half-TTL steps: on a frozen clock every
        renewal re-arms to the same deadline, so one jump past the TTL
        would strand the SURVIVORS too (a renewal at or past the
        deadline is refused by design). Instead the wrap jumps half a
        TTL, BLOCKS (bounded, real time) until every surviving host has
        renewed past that jump (its `service.lease_margins()` entry
        exceeds the remaining half -- the agents' renew loops run on
        the wall clock), then jumps the rest: only the victim's
        deadline is now behind the clock. The sweep that follows
        evicts EXACTLY the victim: one lease expiry, one epoch bump,
        one view change. Needs `ttl_s > 2` so survivors keep a positive
        margin after the second jump."""
        plan = self

        inner_sweep = supervisor.sweep

        def sweep():
            idx = plan._cluster_sweep_counter
            plan._cluster_sweep_counter += 1
            if (idx == plan.cluster_sigkill_at
                    and not plan._spent("agentkill")):
                victim = agents[plan.cluster_sigkill_host]
                ttl = victim.spec.ttl_s
                half = ttl / 2.0
                plan._note("agentkill", idx)
                victim.kill()
                victim.proc.join(10.0)
                clock.advance(half)
                survivors = [h for h in agents
                             if h != plan.cluster_sigkill_host]
                deadline = time.monotonic() + settle_timeout_s
                while True:
                    margins = service.lease_margins()
                    # a pre-jump lease has at most `ttl - half` left;
                    # more proves a renewal AFTER the jump
                    if all(margins.get(h, -1.0) > ttl - half
                           for h in survivors):
                        break
                    if time.monotonic() > deadline:
                        raise FaultError(
                            f"surviving agents never renewed past the "
                            f"clock jump: {margins}")
                    time.sleep(0.02)
                clock.advance(half + 1.0)
            return inner_sweep()

        supervisor.sweep = sweep
        return supervisor

    def wrap_arena(self, arena):
        """Install data-plane faults on a `serve.shm_arena.ShmArena`
        through its `fault_hook` seam (same idiom as the page pool's
        hook). Three schedules, all 0-based:

        - `arena_kill_scatter_at`: SIGKILL THIS process right after
          the nth segment's bytes are written (and before the ticket
          exists anywhere) — the source dying mid-scatter. The
          segments are left SCATTER-state with a dead owner pid: only
          the orphan-reclaim sweep can free them.
        - `arena_kill_adopt_at`: SIGKILL right before the nth
          adoption stamp — the destination dying mid-adopt, AFTER the
          bytes were gathered. The source still owns the segments.
        - `arena_error_at`: the nth `scatter()` call raises
          FaultError-shaped `ArenaError` BEFORE claiming anything —
          the deterministic trigger for the pickle-fallback parity
          tests (never a half-claimed ticket)."""
        from paddle_tpu_torch.serve.shm_arena import ArenaError
        plan = self

        def hook(event: str, ctx: dict) -> None:
            if event == "scatter_begin":
                idx = plan._arena_begin_counter
                plan._arena_begin_counter += 1
                if (idx == plan.arena_error_at
                        and not plan._spent("arenaerr")):
                    plan._note("arenaerr", idx)
                    raise ArenaError(
                        f"injected arena fault at scatter {idx}")
            elif event == "scatter":
                idx = plan._arena_scatter_counter
                plan._arena_scatter_counter += 1
                if (idx == plan.arena_kill_scatter_at
                        and not plan._spent("arenakillsc")):
                    plan._note("arenakillsc", idx)
                    os.kill(os.getpid(), signal.SIGKILL)
            elif event == "adopt":
                idx = plan._arena_adopt_counter
                plan._arena_adopt_counter += 1
                if (idx == plan.arena_kill_adopt_at
                        and not plan._spent("arenakillad")):
                    plan._note("arenakillad", idx)
                    os.kill(os.getpid(), signal.SIGKILL)

        arena.fault_hook = hook
        return arena

    def wrap_cluster(self, supervisor, agents, *, clock, service,
                     settle_timeout_s: float = 30.0):
        """Install a REAL host death on a membership-mode
        `FleetSupervisor`: right before the `cluster_sigkill_at`-th
        sweep, the agent of host `cluster_sigkill_host` (from
        `agents`, a host_id -> AgentProcess map) gets SIGKILL — its
        replica grandchildren die with it on the watchdog chain, and
        nothing deregisters. The membership service's injected
        `ManualClock` then advances in TWO half-TTL steps: on a
        frozen clock every renewal re-arms to the same deadline, so
        one jump past the TTL would strand the SURVIVORS too (a
        renewal at or past the deadline is refused by design — ties
        break toward eviction). Instead the wrap jumps half a TTL,
        BLOCKS (bounded, real time) until every surviving host has
        renewed past that jump (its `service.lease_margins()` entry
        exceeds the remaining half — the agents' renew loops run on
        wall clock), then jumps the rest: only the victim's deadline
        is now behind the clock. The sweep that follows therefore
        evicts EXACTLY the victim: one lease expiry, one epoch bump,
        one view change — the supervisor must learn of the death
        from the VIEW, fence the dead endpoints before any socket
        error, and redistribute with exactly-once outcomes. Needs
        `ttl_s > 2` so survivors keep positive margin after the
        second jump."""
        plan = self

        inner_sweep = supervisor.sweep

        def sweep():
            idx = plan._cluster_sweep_counter
            plan._cluster_sweep_counter += 1
            if (idx == plan.cluster_sigkill_at
                    and not plan._spent("agentkill")):
                victim = agents[plan.cluster_sigkill_host]
                ttl = victim.spec.ttl_s
                half = ttl / 2.0
                plan._note("agentkill", idx)
                victim.kill()
                victim.proc.join(10.0)
                clock.advance(half)
                survivors = [h for h in agents
                             if h != plan.cluster_sigkill_host]
                deadline = time.monotonic() + settle_timeout_s
                while True:
                    margins = service.lease_margins()
                    # a pre-jump lease has at most `ttl - half` left;
                    # more proves a renewal AFTER the jump
                    if all(margins.get(h, -1.0) > ttl - half
                           for h in survivors):
                        break
                    if time.monotonic() > deadline:
                        raise FaultError(
                            f"surviving agents never renewed past "
                            f"the clock jump: {margins}")
                    time.sleep(0.02)
                clock.advance(half + 1.0)
            return inner_sweep()

        supervisor.sweep = sweep
        return supervisor

    def wrap_gang(self, supervisor):
        """Install REAL process faults on a `parallel.launch`
        GangSupervisor: once the victim rank's heartbeat file reports
        step >= `gang_kill_step_at`, the member gets SIGKILL mid-burst
        — its address space, its gloo connections, and any
        half-written checkpoint die with it, and the SURVIVORS are
        left blocked inside a collective that can never complete
        (`proc.wait` after the kill makes the corpse visible before
        the supervisor's classification runs, so the fault is
        deterministic rather than racing the scheduler).
        `gang_wedge_step_at` is the wedged-NOT-dead variant: SIGSTOP —
        the process stays alive, stops heartbeating, and the
        supervisor must fence it with its own SIGKILL before the gang
        can reform."""
        plan = self

        inner_tick = supervisor._tick

        def tick():
            for step_attr, rank_attr, sig, kind in (
                    ("gang_kill_step_at", "gang_kill_rank",
                     signal.SIGKILL, "gangkill"),
                    ("gang_wedge_step_at", "gang_wedge_rank",
                     signal.SIGSTOP, "gangwedge")):
                at = getattr(plan, step_attr)
                if at is None or plan._spent(kind):
                    continue
                rank = getattr(plan, rank_attr)
                proc = supervisor.procs.get(rank)
                if proc is None or proc.poll() is not None:
                    continue
                hb = supervisor.member_heartbeat(rank)
                if hb is not None and hb.get("step", -1) >= at:
                    plan._note(kind, hb.get("step"))
                    os.kill(proc.pid, sig)
                    if sig == signal.SIGKILL:
                        proc.wait(timeout=10)
            return inner_tick()

        supervisor._tick = tick
        return supervisor

    # -- parameter-server faults ------------------------------------------

    def wrap_pserver_shard(self, shard):
        """Install this plan on a `native.pserver.PServerShard` via its
        `fault_hook` seam. Counters are plan-global across every shard
        wrapped by the same plan, so a test wrapping one shard gets
        exact indices; wrapping several interleaves them in arrival
        order. Fault points:

        - "push_recv" (before the update is applied): the
          `pserver_kill_push_at`-th push KILLS the shard — listener
          and connections close, no ACK, nothing applied there;
        - "push_pre_ack" (applied + replicated, reply unsent): the
          `pserver_lost_ack_at`-th push drops the connection — the
          lost-ACK shape whose retry the epoch watermark must DUP;
        - "get_recv" (before rows are read): the
          `pserver_kill_get_at`-th get_rows KILLS the shard — the
          serving read path must fail over to the backup, and any
          cache above it must notice the new authority (failover
          counter) and re-validate, since a backup is a PREFIX of its
          primary and the watermark may legally rewind;
        - "repl_apply" (backup side): the `pserver_replica_delay_at`-th
          replicated record sleeps `pserver_replica_delay_s` — a slow
          replica stretches the chain without breaking it;
        - "snapshot": the `pserver_snapshot_error_at`-th snapshot write
          raises OSError — the flaky-NFS shape, shard must keep
          serving."""
        from paddle_tpu_torch.native import pserver as _ps

        plan = self

        def hook(event: str) -> None:
            if event == "push_recv":
                idx = plan._pserver_push_counter
                plan._pserver_push_counter += 1
                if (idx == plan.pserver_kill_push_at
                        and not plan._spent("pskill")):
                    plan._note("pskill", idx)
                    raise _ps.KillShard(f"injected shard kill on push "
                                        f"#{idx}")
            elif event == "get_recv":
                idx = plan._pserver_get_counter
                plan._pserver_get_counter += 1
                if (idx == plan.pserver_kill_get_at
                        and not plan._spent("psgetkill")):
                    plan._note("psgetkill", idx)
                    raise _ps.KillShard(f"injected shard kill on "
                                        f"get_rows #{idx}")
            elif event == "push_pre_ack":
                idx = plan._pserver_ack_counter
                plan._pserver_ack_counter += 1
                if (idx == plan.pserver_lost_ack_at
                        and not plan._spent("pslostack")):
                    plan._note("pslostack", idx)
                    raise _ps.DropConnection(f"injected lost ACK on "
                                             f"push #{idx}")
            elif event == "repl_apply":
                idx = plan._pserver_repl_counter
                plan._pserver_repl_counter += 1
                if (idx == plan.pserver_replica_delay_at
                        and not plan._spent("psslowrepl")):
                    plan._note("psslowrepl", idx)
                    import time as _time

                    _time.sleep(plan.pserver_replica_delay_s)
            elif event == "snapshot":
                idx = plan._pserver_snap_counter
                plan._pserver_snap_counter += 1
                if (idx == plan.pserver_snapshot_error_at
                        and not plan._spent("pssnap")):
                    plan._note("pssnap", idx)
                    raise OSError(f"injected snapshot-write failure "
                                  f"#{idx}")

        shard.fault_hook = hook
        return shard

    # -- online-learning faults -------------------------------------------

    def wrap_online_trainer(self, trainer):
        """Install this plan on a `train.online.StreamingTrainer` via
        its `fault_hook` seam: the `online_kill_step_at`-th streaming
        step raises FaultError BEFORE the task is fetched — the
        mid-stream death shape. The task's lease expires back to todo,
        and a reformed trainer (same trainer_id, fresh client) must
        resume with its push numbering adopted from the shard's applied
        epochs, so the replayed task's pushes stay exactly-once."""
        plan = self

        def hook(event: str) -> None:
            if event == "step":
                idx = plan._online_step_counter
                plan._online_step_counter += 1
                if (idx == plan.online_kill_step_at
                        and not plan._spent("onlinekill")):
                    plan._note("onlinekill", idx)
                    raise FaultError(f"injected online-trainer death "
                                     f"at step #{idx}")

        trainer.fault_hook = hook
        return trainer

    # -- master-connection faults -----------------------------------------

    def wrap_master_client(self, client):
        """Monkeypatch a native.MasterClient so its socket is torn down
        right before the `master_drop_at`-th RPC — the client's
        backoff-reconnect path must then carry the call."""
        plan = self
        inner_call = client._call

        def flaky_call(payload, idempotent=True):
            idx = plan._call_counter
            plan._call_counter += 1
            if idx == plan.master_drop_at and not plan._spent("drop"):
                plan._note("drop", idx)
                try:
                    client._sock.close()
                except (OSError, AttributeError):
                    pass    # already dropped — the fault still "fired"
            return inner_call(payload, idempotent=idempotent)

        client._call = flaky_call
        return client


def _poison_batch(batch):
    """Replace every float column of the batch (numpy array or tensor,
    on its device) with NaNs -- a genuinely divergent step (NaN forward,
    NaN loss, NaN grads), not a cosmetic one."""

    def poison(x):
        if isinstance(x, torch.Tensor):
            return (torch.full_like(x, float("nan"))
                    if x.is_floating_point() else x)
        arr = np.asarray(x)
        if np.issubdtype(arr.dtype, np.floating):
            return np.full_like(arr, np.nan)
        return x

    if isinstance(batch, tuple):
        return tuple(poison(x) for x in batch)
    return poison(batch)


class ManualClock:
    """Deterministic monotonic clock for serving chaos tests: pass it
    as the server's `clock` and advance it explicitly (or let
    `wrap_engine`'s stall faults advance it) — deadline storms without
    real sleeps, so the chaos suite stays fast and exact."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards ({dt})")
        self._t += float(dt)


class _FaultyEngine:
    """DecodeEngine proxy with FaultPlan-scheduled serving faults.
    Faults raise BEFORE delegating, so the caller's EngineState is
    never half-mutated (prefill/decode_step are pure functions of it —
    the property every requeue path leans on)."""

    def __init__(self, engine, plan: "FaultPlan",
                 clock: Optional[ManualClock]):
        self._engine = engine
        self._plan = plan
        self._clock = clock

    def _burst(self) -> bool:
        plan = self._plan
        idx = plan._serve_call_counter
        plan._serve_call_counter += 1
        if (plan.serve_error_first_n is not None
                and idx < plan.serve_error_first_n):
            plan._note("nativeburst", idx)
            return True
        return False

    def _prefill_fault(self):
        plan = self._plan
        burst = self._burst()
        idx = plan._serve_prefill_counter
        plan._serve_prefill_counter += 1
        if burst:
            raise FaultError(f"injected native fault (burst) on "
                             f"prefill #{idx}")
        if (idx == plan.serve_prefill_error_at
                and not plan._spent("sprefill")):
            plan._note("sprefill", idx)
            raise FaultError(f"injected prefill fault #{idx}")

    def init_state(self, *args, **kwargs):
        """Delegate, then install the plan on the freshly built page
        pool — wrap_engine alone is enough for paged faults even
        though the server rebuilds pools on reset/backend switch."""
        state = self._engine.init_state(*args, **kwargs)
        pool = getattr(self._engine, "pool", None)
        if pool is not None:
            self._plan.wrap_page_pool(pool)
        return state

    def prefill(self, *args, **kwargs):
        self._prefill_fault()
        return self._engine.prefill(*args, **kwargs)

    def prefill_begin(self, *args, **kwargs):
        # host-side bookkeeping only — faults strike the chunks (the
        # forward work), mirroring "raises BEFORE touching the engine"
        return self._engine.prefill_begin(*args, **kwargs)

    def prefill_advance(self, state, ticket):
        """Each chunk counts as one prefill call for the fault
        schedule: serve_prefill_error_at can strike any chunk of a
        chunked prefill, and the burst counter keeps ticking."""
        self._prefill_fault()
        return self._engine.prefill_advance(state, ticket)

    def _decode_fault(self):
        plan = self._plan
        burst = self._burst()
        idx = plan._serve_decode_counter
        plan._serve_decode_counter += 1
        if burst:
            raise FaultError(f"injected native fault (burst) on "
                             f"decode step #{idx}")
        if idx == plan.serve_stall_at and not plan._spent("stall"):
            plan._note("stall", idx)
            if self._clock is not None:
                self._clock.advance(plan.serve_stall_s)
        if (idx == plan.serve_decode_error_at
                and not plan._spent("sdecode")):
            plan._note("sdecode", idx)
            raise FaultError(f"injected decode fault #{idx}")

    def decode_step(self, state):
        self._decode_fault()
        return self._engine.decode_step(state)

    def spec_step(self, state, drafts, draft_len):
        # a speculative verify round rides the SAME decode fault
        # schedule (one round = one decode call), so
        # serve_decode_error_at / bursts strike speculative serving
        # at the same points as plain decoding
        self._decode_fault()
        return self._engine.spec_step(state, drafts, draft_len)

    def __getattr__(self, name):
        return getattr(self._engine, name)


class _DoomedReplicaEngine:
    """DecodeEngine proxy for fleet chaos: healthy (bit-identical
    delegation) until `router_kill_decode_at` fires, then PERMANENTLY
    dead — every engine call raises the replica-fatal
    ReplicaDeadError, like a device that fell off the bus. Optional
    persistent slow-decode clock skew rides the same wrapper."""

    def __init__(self, engine, plan: "FaultPlan",
                 clock: Optional["ManualClock"]):
        self._engine = engine
        self._plan = plan
        self._clock = clock
        self.dead = False

    def _dead_error(self):
        from paddle_tpu_torch.serve.router import ReplicaDeadError

        return ReplicaDeadError(
            "injected replica death (fault plan)")

    def _check_dead(self):
        if self.dead:
            raise self._dead_error()

    def ping(self):
        self._check_dead()
        return self._engine.ping()

    def init_state(self, *args, **kwargs):
        self._check_dead()
        return self._engine.init_state(*args, **kwargs)

    def prefill(self, *args, **kwargs):
        self._check_dead()
        return self._engine.prefill(*args, **kwargs)

    def prefill_begin(self, *args, **kwargs):
        self._check_dead()
        return self._engine.prefill_begin(*args, **kwargs)

    def prefill_advance(self, *args, **kwargs):
        self._check_dead()
        return self._engine.prefill_advance(*args, **kwargs)

    def ensure_decode_page(self, *args, **kwargs):
        self._check_dead()
        return self._engine.ensure_decode_page(*args, **kwargs)

    def _decode_tick(self):
        self._check_dead()
        plan = self._plan
        idx = plan._router_decode_counter
        plan._router_decode_counter += 1
        if plan.router_slow_decode_s > 0 and self._clock is not None:
            self._clock.advance(plan.router_slow_decode_s)
        if (idx == plan.router_kill_decode_at
                and not plan._spent("replicakill")):
            plan._note("replicakill", idx)
            self.dead = True
            raise self._dead_error()

    def decode_step(self, state):
        self._decode_tick()
        return self._engine.decode_step(state)

    def spec_step(self, state, drafts, draft_len):
        # verify rounds tick the same kill schedule as plain steps:
        # router_kill_decode_at can strike MID-BURST during
        # speculative serving (the counter-reconciliation chaos case)
        self._decode_tick()
        return self._engine.spec_step(state, drafts, draft_len)

    # -- disaggregation migration surface (dead-stays-dead too) --------

    def pause_slot(self, *args, **kwargs):
        self._check_dead()
        return self._engine.pause_slot(*args, **kwargs)

    def export_slot_kv(self, *args, **kwargs):
        self._check_dead()
        return self._engine.export_slot_kv(*args, **kwargs)

    def resume_slot(self, *args, **kwargs):
        self._check_dead()
        return self._engine.resume_slot(*args, **kwargs)

    def import_slot_kv(self, *args, **kwargs):
        """The migration-destination kill point: the
        `router_kill_import_at`-th import across engines wrapped by
        this plan dies MID-TRANSFER — after the destination pool
        mapped pages, before the arena write lands — and the replica
        is dead from then on, exactly like a device lost with the DMA
        in flight."""
        self._check_dead()
        plan = self._plan
        idx = plan._router_import_counter
        plan._router_import_counter += 1
        if (idx == plan.router_kill_import_at
                and not plan._spent("importkill")):
            plan._note("importkill", idx)
            self.dead = True
            raise self._dead_error()
        return self._engine.import_slot_kv(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._engine, name)


def garbage_prompts(vocab: int, max_prompt_len: int) -> dict:
    """Canonical malformed serving inputs, keyed by failure mode. The
    admission validator (serve.server / engine.serve entry checks)
    must reject every one with a clear ValueError — none may reach
    prefill or crash the pool."""
    return {
        "empty": np.zeros((0,), np.int32),
        "oversized": np.zeros((max_prompt_len + 1,), np.int32),
        "out_of_vocab": np.asarray([0, vocab + 7, 1], np.int32),
        "negative_id": np.asarray([3, -1, 2], np.int32),
        "float_dtype": np.asarray([0.5, 1.5], np.float32),
        "not_1d": np.zeros((2, 3), np.int32),
    }


class _FlakyCheckpoints:
    """CheckpointManager proxy: the `checkpoint_error_at`-th save()
    raises OSError (the full-disk / flaky-NFS case); everything else
    delegates."""

    def __init__(self, manager, plan: FaultPlan):
        self._manager = manager
        self._plan = plan

    def save(self, state, step: Optional[int] = None, **kwargs):
        idx = self._plan._save_counter
        self._plan._save_counter += 1
        if (idx == self._plan.checkpoint_error_at
                and not self._plan._spent("ckpt")):
            self._plan._note("ckpt", idx)
            raise OSError(f"injected checkpoint-write failure on "
                          f"save #{idx}")
        return self._manager.save(state, step, **kwargs)

    def __getattr__(self, name):
        return getattr(self._manager, name)


def build_chaos_replica(fault_plan: Optional[dict] = None, **kwargs):
    """Spawn-importable `ReplicaSpec` builder for data-plane chaos:
    `serve.fleet.build_server_from_config` plus a `FaultPlan` armed on
    the replica's OWN arena handle (`fault_plan` is the plan's kwargs --
    plain data, as the spawn boundary requires). Chaos runs point
    prefill/decode children here to die by SIGKILL mid-scatter or
    mid-adopt inside a REAL process, then check that the supervisor's
    orphan-reclaim sweep frees every segment."""
    from paddle_tpu_torch.serve.fleet import build_server_from_config

    server = build_server_from_config(**kwargs)
    if fault_plan and server.data_plane is not None:
        FaultPlan(**fault_plan).wrap_arena(server.data_plane)
    return server
