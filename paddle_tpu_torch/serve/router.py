"""Multi-replica serving fleet: the prefix-affinity router (port of
`paddle_tpu.serve.router`, which is host-side scheduling only: the
module is the JAX package's, over the port's server and page pool).

One `ServingServer` is a single box: a replica loss takes every
in-flight request and the whole prefix cache with it, and full-program
compilation (PAPERS.md: arxiv 1810.09868) makes a replica restart
expensive enough that ROUTING AROUND failure — not waiting out a
recompile — is the only production answer. `ServingRouter` fronts N
replicas (each a `ServingServer` over its own `DecodeEngine` pool) and
owns three jobs:

- **Prefix-affinity routing.** The paged pool's chained block hashes
  (serve.paged, "Ragged Paged Attention", arxiv 2604.15464) are
  exactly the routing key: the router derives a prompt's chain with
  THE SAME `paged.chain_keys` the replica-local prefix caches hash
  with, keeps a bounded LRU affinity map (chain key -> replica), and
  lands a request on the replica holding its DEEPEST cached prefix —
  so the fleet-wide hit rate approaches the single-box rate instead of
  dividing by N. A miss (or an unroutable affinity target) spills to
  the least-loaded replica; which replica wins is a
  `SchedulerPolicy.route`/`spill` decision, so routing policy is
  pluggable like every other scheduling choice.

- **Health-checked failover.** Each replica carries the same
  `CircuitBreaker` idiom the server uses for its native backend:
  periodic probes (injectable clock, `probe_interval_s`) feed the
  breaker, an open breaker takes the replica out of the candidate set,
  and after `cooldown_s` the half-open probe decides — closed on
  success, re-opened on failure. A probe BLACKHOLE (probes fail while
  the replica might be fine) therefore degrades to "stop routing
  there", never to a hang.

- **Redistribution on replica loss.** A dead replica's engine raises a
  replica-fatal error out of `ServingServer.step()` with the host-side
  scheduler LEDGER intact (`pending_requests()`); the router harvests
  it and resubmits every request that had NO terminal outcome to a
  survivor — remaining `retries_left` carried over (budgets intact),
  remaining deadline recomputed on the shared clock, original sampling
  preserved. Requests whose outcome already landed keep it. The
  invariant the chaos suite (`tests/test_router.py`) proves: every
  router-submitted request ends in EXACTLY ONE outcome — never lost
  with the device, never served twice — and the fleet's counters
  reconcile. Redistributed decodes restart from a fresh prefill on the
  survivor (recompute failover): greedy and explicitly-seeded
  requests yield the exact tokens they would have without the kill.

Planned maintenance uses `retire_replica()` instead: stop routing to
the replica, redistribute its QUEUE immediately, let its in-flight
work finish in place, then drop it from the sweep — zero recompute.

The router is pure host-side scheduling: it touches no device value.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from paddle_tpu_torch.obs.flight import FlightRecorder
from paddle_tpu_torch.obs.trace import Tracer
from paddle_tpu_torch.serve.paged import chain_keys
from paddle_tpu_torch.serve.policy import SchedulerPolicy
from paddle_tpu_torch.serve.server import (COMPLETED, EXPIRED, FAILED,
                                           OUTCOMES, SHED, CircuitBreaker,
                                           MigrationRefusedError,
                                           QueueFullError, Request,
                                           ServingServer)


class ReplicaDeadError(RuntimeError):
    """A replica's engine is GONE (device lost, process killed). The
    `replica_fatal` marker tells `ServingServer.step()` to propagate
    instead of burning retry budgets against a corpse; the router
    catches it, marks the replica dead, and redistributes."""

    replica_fatal = True


@dataclasses.dataclass
class RouterResult:
    """Terminal record for one router-submitted request. `replica` is
    the replica that produced the outcome; `redistributions` counts
    replica-loss handoffs (0 for a request that never moved);
    `retries` mirrors the serving-level transient-retry count."""

    rr_id: int
    outcome: str
    tokens: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    replica: Optional[int] = None
    redistributions: int = 0
    retries: int = 0
    done_at: float = 0.0        # the serving replica's clock


class Replica:
    """One fleet member: a `ServingServer` plus its health state.
    `probe_hook` is the fault seam (`FaultPlan.wrap_probe`): a raising
    hook is a blackholed health check."""

    def __init__(self, rid: int, server: ServingServer,
                 breaker: CircuitBreaker):
        self.rid = rid
        self.server = server
        self.breaker = breaker
        self.alive = True
        self.retired = False
        # rep-local req_id -> router rr_id, for every request routed
        # here whose outcome has not been mirrored yet
        self.pending: Dict[int, int] = {}
        self.probe_hook: Optional[Callable] = None

    def load(self) -> int:
        return self.server.load()

    def routable(self) -> bool:
        """May NEW traffic land here? Alive, not retiring, and the
        health breaker closed — half-open replicas are probed back to
        health, not fed live requests."""
        return (self.alive and not self.retired
                and self.breaker.state == "closed")

    def probe(self) -> None:
        """One health check: the hook seam first (a raising hook is a
        blackholed probe), then the server's `ping()` — which touches
        the active backend, so a dead engine raises here exactly like
        a lost device answering its first RPC."""
        if self.probe_hook is not None:
            self.probe_hook(self)
        if not self.alive:
            raise ReplicaDeadError(f"replica {self.rid} is dead")
        self.server.ping()


class ServingRouter:
    """Front N `ServingServer` replicas with prefix-affinity routing,
    health-checked failover, and exactly-once redistribution. Drive it
    like a server: `submit()` traffic, `run()` until the fleet drains,
    `counters()`/`reconcile()` for the ledger. The drive loop
    round-robins one `step()` per live replica per sweep, so a slow
    replica skews its own latency, not the fleet's."""

    def __init__(self, servers: List[ServingServer], *,
                 clock: Callable[[], float] = time.monotonic,
                 failure_threshold: int = 3,
                 cooldown_s: float = 30.0,
                 probe_interval_s: float = 5.0,
                 affinity_blocks: int = 4096,
                 policy: Optional[SchedulerPolicy] = None,
                 tracer: Optional[Tracer] = None,
                 flight: Optional[FlightRecorder] = None,
                 flight_dir: Optional[str] = None):
        if not servers:
            raise ValueError("a fleet needs >= 1 replica")
        self.clock = clock
        self.policy = (policy if policy is not None
                       else SchedulerPolicy())
        self.probe_interval_s = probe_interval_s
        self.affinity_blocks = affinity_blocks
        # kept for add_replica(): late joiners (the fleet
        # supervisor's scale-out path) get the same breaker contract
        # as the founding members
        self._failure_threshold = failure_threshold
        self._cooldown_s = cooldown_s
        self.replicas = [
            Replica(i, srv, CircuitBreaker(
                failure_threshold=failure_threshold,
                cooldown_s=cooldown_s, clock=clock))
            for i, srv in enumerate(servers)]
        # disaggregated prefill/decode: any non-unified replica role
        # turns on tiered routing + the migration sweep. A prefill
        # tier without a decode tier would park every request forever
        # and cancel every handoff — reject the mis-wiring up front.
        roles = [getattr(s, "role", "unified") for s in servers]
        self._disagg = any(r != "unified" for r in roles)
        if "prefill" in roles and "decode" not in roles:
            raise ValueError(
                "a prefill-tier replica needs at least one "
                "decode-tier replica to migrate to")
        # affinity key geometry comes from the replica engines; a
        # non-paged fleet (ring pools have no prefix cache) routes by
        # load alone
        eng = servers[0].engine
        self._paged = bool(getattr(eng, "paged", False)
                           and getattr(eng, "prefix_cache", False))
        self._page_size = int(getattr(eng, "page_size", 0) or 0)
        # chain key -> Replica, LRU-bounded like the replica caches
        self._affinity: "collections.OrderedDict[tuple, Replica]" = \
            collections.OrderedDict()
        self.results: Dict[int, RouterResult] = {}
        self._next_id = 0
        self._last_probe = float("-inf")
        # rr_id -> redistribution hops so far, for requests currently
        # living on their second-or-later replica
        self._moved: Dict[int, int] = {}
        # rr_id -> reason for cancels that must survive a failover
        # race: re-applied after redistribution, cleared at the
        # terminal outcome
        self._cancel_wanted: Dict[int, str] = {}
        # fleet ledger counters (requests is submissions; the outcome
        # keys tally self.results exactly — reconcile() asserts it)
        self.stats: Dict[str, int] = {
            "requests": 0, "completed": 0, "expired": 0, "shed": 0,
            "failed": 0, "redistributed": 0, "replicas_lost": 0,
            "affinity_hits": 0, "affinity_spills": 0,
            # disaggregation: completed cross-tier KV migrations,
            # transfers that had to retry another destination
            # (refused / destination died mid-import), and handoffs
            # cancelled back to source-local decode
            "migrations": 0, "migration_retargets": 0,
            "migration_failed": 0, "replicas_reaped": 0}
        # dead replicas' pool counters, banked at death so aggregate
        # prefix-hit observability never goes backwards
        self._dead_base: Dict[str, int] = {}
        # observability (paddle_tpu.obs). The router mints the fleet
        # request-id (`rr<N>`) and starts the span; the SERVING
        # REPLICA ends it at the terminal outcome (the same tracer is
        # normally shared), and `_record` closes any span a
        # tracer-less replica left open — exactly one terminal span
        # per rr id either way. `flight_dir` is where the ring dumps
        # on replica death.
        self.tracer = tracer
        self.flight = flight
        self.flight_dir = flight_dir

    # -- routing -----------------------------------------------------------

    def _chain(self, prompt) -> List[tuple]:
        if not self._paged:
            return []
        arr = np.asarray(prompt)
        if arr.ndim != 1 or not np.issubdtype(arr.dtype, np.integer):
            # malformed traffic gets NO affinity key — it still
            # routes (spill), and the replica's validator rejects it
            # with the documented ValueError
            return []
        return chain_keys(arr, int(arr.size), self._page_size)

    def _note_affinity(self, chain: List[tuple], rep: Replica) -> None:
        """The chosen replica is about to prefill (and so register)
        every block on this chain: point the affinity map there.
        Bounded LRU, mirroring the replica-local cache bound."""
        for key in chain:
            if key in self._affinity:
                self._affinity.move_to_end(key)
            self._affinity[key] = rep
        while len(self._affinity) > self.affinity_blocks:
            self._affinity.popitem(last=False)

    def _pick(self, chain: List[tuple]) -> Optional[Replica]:
        cands = [r for r in self.replicas if r.routable()]
        # prefer replicas with admission-queue space: an affinity
        # target that is FULL is a miss (spill costs one prefill; a
        # shed loses the request) — only when EVERY queue is full do
        # all candidates stay in, so the replica-level displacement
        # shed still decides genuine fleet-wide overload
        roomy = [r for r in cands if r.server.queue_space > 0]
        pool = roomy or cands
        if self._disagg:
            rep = self.policy.route_tiered(
                chain, self._affinity,
                [r for r in pool if r.server.role != "decode"],
                [r for r in pool if r.server.role == "decode"])
        else:
            rep = self.policy.route(chain, self._affinity, pool)
        if rep is not None:
            hit = any(self._affinity.get(k) is rep
                      for k in reversed(chain))
            self.stats["affinity_hits" if hit
                       else "affinity_spills"] += 1
        return rep

    def submit(self, prompt, *, max_new: int,
               deadline_ms: Optional[float] = -1,
               sampling: Optional[dict] = None) -> int:
        """Route one request into the fleet; returns its router-level
        rr_id. Mirrors the single-server contract: malformed input
        raises ValueError (ledgered FAILED), an overload shed raises
        QueueFullError (ledgered SHED) — both carry `.rr_id` so burst
        callers reconcile without catching. Either way the request has
        exactly one outcome in `results` eventually."""
        rr_id = self._next_id
        self._next_id += 1
        self.stats["requests"] += 1
        tid = self.trace_id(rr_id)
        if self.tracer is not None:
            self.tracer.start(tid, "fleet.request", rr_id=rr_id)
        chain = self._chain(prompt)
        while True:
            rep = self._pick(chain)
            if rep is None:
                res = RouterResult(
                    rr_id=rr_id, outcome=SHED,
                    error="load shed: no routable replica (fleet "
                          "unhealthy or draining)")
                self._record(res)
                err = QueueFullError(res.error)
                err.rr_id = rr_id
                raise err
            try:
                rep_id = rep.server.submit(
                    prompt, max_new=max_new, deadline_ms=deadline_ms,
                    sampling=sampling, trace_id=tid)
            except ValueError as e:
                # deterministic rejection by the replica's validator —
                # mirror its (already ledgered) FAILED result
                self._record(RouterResult(
                    rr_id=rr_id, outcome=FAILED, error=str(e),
                    replica=rep.rid))
                e.rr_id = rr_id
                raise
            except QueueFullError as e:
                # the replica shed the INCOMING request as cheapest to
                # retry (a displaced QUEUED victim is mirrored on the
                # next sweep instead)
                self._record(RouterResult(
                    rr_id=rr_id, outcome=SHED, error=str(e),
                    replica=rep.rid))
                e.rr_id = rr_id
                raise
            except Exception as e:
                # a PROCESS replica can die at submission time (the
                # socket is the first to know): standard failover —
                # mark it dead, redistribute ITS pending work, and
                # re-pick a survivor for THIS request
                if not getattr(e, "replica_fatal", False):
                    raise
                self._on_replica_death(rep, e)
                continue
            break
        rep.pending[rep_id] = rr_id
        self._note_affinity(chain, rep)
        return rr_id

    def _holder(self, rr_id: int):
        """Which live replica currently owns `rr_id`, and under which
        rep-local id — the reverse of the `pending` maps. None/None
        once terminal (or mid-failover, between harvest and
        redistribution)."""
        for rep in self.replicas:
            if not rep.alive:
                continue
            for rep_id, rid in rep.pending.items():
                if rid == rr_id:
                    return rep, rep_id
        return None, None

    def cancel(self, rr_id: int, *,
               reason: str = "client cancelled") -> bool:
        """Cancel one router-submitted request (the HTTP edge's
        client-disconnect path): force-expires it on whichever
        replica holds it NOW, and — because a replica crash can race
        the cancel — remembers the intent so `_redistribute` re-
        applies it on the survivor. The request still ends in exactly
        one terminal outcome (EXPIRED), mirrored on the next sweep.
        Returns False once `rr_id` is already terminal (or was never
        submitted — an id this router hasn't minted must not park a
        wanted-cancel forever)."""
        if rr_id in self.results:
            return False
        if not (0 <= rr_id < self._next_id):
            return False
        self._cancel_wanted[rr_id] = reason
        if self.tracer is not None:
            self.tracer.event(self.trace_id(rr_id), "cancel",
                              reason=reason)
        rep, rep_id = self._holder(rr_id)
        if rep is None:
            return True         # queued for redistribution: re-applied there
        try:
            rep.server.cancel(rep_id, reason=reason)
        except Exception as e:
            if not getattr(e, "replica_fatal", False):
                raise
            # the replica died answering the cancel: normal failover
            # (the wanted-cancel re-applies on the survivor)
            self._on_replica_death(rep, e)
        return True

    def partial_tokens(self, rr_id: int) -> List[int]:
        """Streaming read: the tokens emitted so far for `rr_id`,
        wherever it lives — the owning replica's accumulation buffer
        while decoding, the fleet ledger once terminal. After a
        replica loss the count can step BACKWARD while the survivor
        regenerates (greedy decode regenerates the identical prefix),
        so a streaming caller must send only beyond its own
        high-water mark."""
        res = self.results.get(rr_id)
        if res is not None:
            return list(res.tokens)
        rep, rep_id = self._holder(rr_id)
        if rep is None:
            return []
        try:
            return list(rep.server.partial_tokens(rep_id))
        except Exception as e:
            if not getattr(e, "replica_fatal", False):
                raise
            self._on_replica_death(rep, e)
            return []

    # -- the ledger --------------------------------------------------------

    @staticmethod
    def trace_id(rr_id: int) -> str:
        """The fleet-wide trace id for one router submission — minted
        here, propagated down through the replica's scheduler, the
        engine and the page pool (obs.trace)."""
        return f"rr{rr_id}"

    def _record(self, res: RouterResult) -> None:
        assert res.rr_id not in self.results, (
            f"request {res.rr_id} already has outcome "
            f"{self.results[res.rr_id].outcome}, refusing a second")
        self.results[res.rr_id] = res
        self.stats[res.outcome] += 1
        self._cancel_wanted.pop(res.rr_id, None)
        if self.tracer is not None:
            # the serving replica normally ended the span at its
            # terminal outcome; a tracer-less replica (or a router-
            # level shed with no replica at all) leaves it open —
            # close it here so every rr id gets exactly one terminal
            # span. get() only returns LIVE spans, so this never
            # double-ends.
            tid = self.trace_id(res.rr_id)
            if self.tracer.get(tid) is not None:
                self.tracer.end(tid, res.outcome, error=res.error,
                                replica=res.replica,
                                redistributions=res.redistributions)

    def _mirror(self, rep: Replica) -> None:
        """Pull newly-terminal outcomes from the replica's ledger into
        the fleet ledger. Carries the redistribution count forward so
        a handed-off request's final record names every hop."""
        for rep_id in [i for i in rep.pending
                       if i in rep.server.results]:
            rr_id = rep.pending.pop(rep_id)
            r = rep.server.results[rep_id]
            prior = self._moved.get(rr_id, 0)
            self._record(RouterResult(
                rr_id=rr_id, outcome=r.outcome,
                tokens=list(r.tokens), logprobs=list(r.logprobs),
                error=r.error, replica=rep.rid,
                redistributions=prior, retries=r.retries,
                done_at=r.done_at))
            self._moved.pop(rr_id, None)

    # -- failover ----------------------------------------------------------

    def _bank_pool_counters(self, rep: Replica) -> None:
        # monotone counters only — live gauges (pages_in_use) and
        # derived ratios (acceptance_rate) don't bank; the spec
        # ledger banks EXACTLY ONCE here (death is the only transfer
        # of a dead replica's counts into the aggregate)
        for k, v in rep.server.counters().items():
            if k in ("prefix_hits", "prefix_misses", "prefix_rejected",
                     "prefill_chunks", "requests", "completed",
                     "expired", "shed", "failed", "retried",
                     "admitted", "spec_rounds", "draft_proposed",
                     "draft_accepted", "spec_reserved",
                     "spec_rolled_back", "migrated_in", "migrated_out",
                     "migrated_out_pages", "migrated_in_pages",
                     "handoffs_cancelled", "data_plane_fallbacks",
                     "rpc_frames_coalesced", "rpc_client_frames",
                     "rpc_client_bytes_sent", "rpc_client_bytes_recv"):
                self._dead_base[k] = self._dead_base.get(k, 0) + v

    def _on_replica_death(self, rep: Replica, exc: Exception) -> None:
        """The crash path: mark dead, drop its affinity entries (its
        cache died with it), mirror what already finished, and
        redistribute everything still pending — remaining retry
        budgets and deadlines intact, exactly one outcome each."""
        rep.alive = False
        rep.breaker.record_failure()
        self.stats["replicas_lost"] += 1
        if self.flight is not None:
            self.flight.record(
                "fault", "replica-death", replica=rep.rid,
                error=str(exc), pending=len(rep.pending))
        for key in [k for k, r in self._affinity.items() if r is rep]:
            del self._affinity[key]
        self._mirror(rep)           # outcomes that beat the crash
        self._bank_pool_counters(rep)
        ledger = {r.req_id: r for r in rep.server.pending_requests()}
        for rep_id, rr_id in sorted(rep.pending.items()):
            req = ledger.get(rep_id)
            self._redistribute(
                rr_id, req,
                why=f"replica {rep.rid} lost ({exc})")
        rep.pending.clear()
        if self.flight is not None and self.flight_dir:
            self.flight.dump(
                self.flight_dir, f"replica-death-r{rep.rid}",
                extra={"error": str(exc),
                       "counters": self.counters()})

    def _redistribute(self, rr_id: int, req: Optional[Request],
                      why: str) -> None:
        if req is None:
            # cannot happen through the harvest contract (pending =
            # not-terminal = in the ledger); terminal defense so a
            # request is never silently dropped
            self._record(RouterResult(
                rr_id=rr_id, outcome=FAILED,
                error=f"request lost in failover: {why}"))
            return
        moves = self._moved.get(rr_id, 0) + 1
        self._moved[rr_id] = moves
        self.stats["redistributed"] += 1
        if self.tracer is not None:
            self.tracer.event(self.trace_id(rr_id), "redistributed",
                              why=why, moves=moves)
        chain = self._chain(req.prompt)
        rep = self._pick(chain)
        if rep is None:
            self._moved.pop(rr_id, None)
            self._record(RouterResult(
                rr_id=rr_id, outcome=FAILED,
                error=f"no live replica to redistribute to: {why}",
                redistributions=moves))
            return
        remaining_ms = (None if req.deadline is None else
                        (req.deadline - self.clock()) * 1000.0)
        try:
            rep_id = rep.server.submit(
                req.prompt, max_new=req.max_new,
                deadline_ms=remaining_ms, sampling=req.sampling,
                retries_left=req.retries_left,
                trace_id=self.trace_id(rr_id))
        except (ValueError, QueueFullError) as e:
            # the survivor's validator/shed verdict IS the outcome
            # (an already-expired deadline lands here as shed/failed
            # only via overload; expiry itself is handled in-queue)
            self._moved.pop(rr_id, None)
            self._record(RouterResult(
                rr_id=rr_id, outcome=(
                    FAILED if isinstance(e, ValueError) else SHED),
                error=f"redistribution refused: {e}",
                replica=rep.rid, redistributions=moves))
            return
        rep.pending[rep_id] = rr_id
        self._note_affinity(chain, rep)
        if rr_id in self._cancel_wanted:
            # a client disconnect raced the replica loss: re-apply the
            # cancel on the survivor. Best-effort — if THIS replica is
            # also dying, the next probe/sweep finds the corpse and
            # the wanted-cancel re-applies on the hop after.
            try:
                rep.server.cancel(rep_id,
                                  reason=self._cancel_wanted[rr_id])
            except Exception as e:
                if not getattr(e, "replica_fatal", False):
                    raise

    # -- KV-block migration (disaggregated mode) ---------------------------

    def _harvest_handoffs(self, rep: Replica) -> int:
        """Migrate every prefill-complete request parked on `rep` to
        the decode tier. Returns how many requests MOVED (migrated or
        cancelled back to local decode) so the sweep knows new work
        exists somewhere."""
        moved = 0
        for req_id in rep.server.ready_handoffs():
            moved += self._migrate(rep, req_id)
        return moved

    def _migrate(self, src: Replica, req_id: int) -> int:
        """One live KV-block migration: export the parked request's
        payload once, then offer it to decode-tier replicas in
        policy order. A transient refusal (MigrationRefusedError) or
        a destination dying mid-import costs nothing — the source's
        export pins keep its copy whole, so the SAME payload retries
        the next destination; only after every destination refused
        does the handoff cancel back to source-local decode (graceful
        degrade, never a lost request). On success the destination
        ACK (`handoff_complete`) releases the source copy, the fleet
        ledger re-homes the rr id, and the affinity map repoints the
        prompt's chain at the destination — whose prefix cache the
        migrated blocks just seeded."""
        rr_id = src.pending.get(req_id)
        try:
            payload = src.server.export_request(req_id)
        except KeyError:
            return 0        # expired/retired between harvest and here
        chain = self._chain(payload["prompt"])
        tried: set = set()
        while True:
            cands = [r for r in self.replicas
                     if r.routable() and r.server.role == "decode"
                     and r.rid not in tried]
            dst = self.policy.migration_target(cands)
            if dst is None:
                break
            tried.add(dst.rid)
            try:
                dst_id = dst.server.import_request(payload)
            except MigrationRefusedError as e:
                self.stats["migration_retargets"] += 1
                if self.tracer is not None and rr_id is not None:
                    self.tracer.event(self.trace_id(rr_id),
                                      "migration_refused",
                                      dst=dst.rid, why=str(e))
                continue
            except Exception as e:
                if not getattr(e, "replica_fatal", False):
                    raise
                # destination died MID-TRANSFER: its commit-last
                # import never registered the request, the source
                # pins are intact — mark it dead (redistributing ITS
                # other pending work) and retry the next destination
                self.stats["migration_retargets"] += 1
                if self.flight is not None:
                    self.flight.record(
                        "fault", "migration-dst-death", src=src.rid,
                        dst=dst.rid, req_id=req_id, error=str(e))
                self._on_replica_death(dst, e)
                continue
            src.server.handoff_complete(req_id)
            if rr_id is not None:
                src.pending.pop(req_id, None)
                dst.pending[dst_id] = rr_id
            self._note_affinity(chain, dst)
            self.stats["migrations"] += 1
            if self.tracer is not None and rr_id is not None:
                self.tracer.event(self.trace_id(rr_id), "migrated",
                                  src=src.rid, dst=dst.rid,
                                  pages=payload["n_pages"])
            return 1
        # no destination could take it: decode where the KV already is
        src.server.cancel_handoff(req_id)
        self.stats["migration_failed"] += 1
        if self.tracer is not None and rr_id is not None:
            self.tracer.event(self.trace_id(rr_id),
                              "migration_cancelled", src=src.rid)
        return 1

    def drain(self, reason: str = "drain requested") -> None:
        """Fleet-wide graceful drain (the SIGTERM path): every live
        replica stops admitting, sheds its queue, and finishes
        in-flight work within its own drain grace; `run()` then
        mirrors the outcomes as usual. New submits shed with the
        replica's draining error."""
        for rep in self.replicas:
            if rep.alive:
                rep.server.drain(reason=reason)

    @property
    def draining(self) -> bool:
        return any(rep.alive and rep.server.draining
                   for rep in self.replicas)

    def queue_space(self) -> int:
        """Free admission capacity across routable replicas — batch
        feeders submit at most this many before the next run()."""
        return sum(r.server.queue_space for r in self.replicas
                   if r.routable())

    def retire_replica(self, rid: int,
                       reason: str = "retired") -> None:
        """The PLANNED-maintenance path: stop routing to the replica,
        redistribute its queue NOW (those requests never started, so
        the handoff is free), and let its in-flight slots finish in
        place — zero recompute, then the sweep drops it once idle."""
        rep = self.replicas[rid]
        rep.retired = True
        for req in list(rep.server.queue):
            # the replica never produced an outcome for these: the
            # server withdraws them from its own ledger (queue +
            # submission counter, one operation — ServingServer owns
            # its books) and they route as a fresh redistribution,
            # budgets intact
            if rep.server.withdraw_queued(req.req_id) is None:
                continue
            rr_id = rep.pending.pop(req.req_id, None)
            if rr_id is None:
                continue
            self._redistribute(rr_id, req, why=reason)

    # -- elastic membership (the fleet supervisor's surface) ---------------

    def declare_dead(self, rid: int, reason: str) -> None:
        """Externally-sourced death: a membership view change says
        this replica's HOST is gone (lease expiry — `cluster.
        membership`), before any socket on it has had to fail. Runs
        the exact crash path `_on_replica_death` takes for a
        transport-detected death: pending work is harvested from the
        mirror ledger and redistributed with retry budgets and
        deadlines intact. Idempotent — a replica the sweep already
        buried is a no-op, so the socket path and the view-change
        path can both fire in either order."""
        rep = self.replicas[rid]
        if not rep.alive:
            return
        self._on_replica_death(rep, ReplicaDeadError(reason))

    def add_replica(self, server) -> int:
        """Join a new replica to the fleet mid-flight (scale-out,
        rolling-upgrade replacement). It gets the same breaker
        contract as the founding members and enters the NEXT sweep;
        rids are append-only, so a reaped rid is never reused and
        per-replica records stay unambiguous."""
        rid = len(self.replicas)
        self.replicas.append(Replica(rid, server, CircuitBreaker(
            failure_threshold=self._failure_threshold,
            cooldown_s=self._cooldown_s, clock=self.clock)))
        return rid

    def reap_replica(self, rid: int) -> None:
        """Drop an EMPTY retired replica from the sweep — the
        graceful symmetric of `_on_replica_death`: outcomes already
        mirrored, counters banked (aggregate observability stays
        monotone), affinity entries dropped. The caller (the fleet
        supervisor) guarantees the replica finished its in-flight
        work; anything still pending would violate exactly-once, so
        it is asserted, not redistributed."""
        rep = self.replicas[rid]
        if not rep.alive:
            return              # death already banked everything
        self._mirror(rep)
        assert not rep.pending, (
            f"reap of replica {rid} with work still pending "
            f"{rep.pending} — retire and drain first")
        self._bank_pool_counters(rep)
        for key in [k for k, r in self._affinity.items() if r is rep]:
            del self._affinity[key]
        rep.alive = False
        self.stats["replicas_reaped"] += 1

    # -- health ------------------------------------------------------------

    def _probe_due(self) -> bool:
        return (self.clock() - self._last_probe
                >= self.probe_interval_s)

    def probe_all(self) -> None:
        """One health sweep: every non-dead replica gets a probe; the
        breaker ingests the verdict (open after failure_threshold
        consecutive failures; half-open probes close on success).
        `allow()` gates the probe so the breaker's half-open contract
        holds: ONE post-cooldown probe decides — success closes,
        failure RE-OPENS for another full cooldown (without allow()'s
        sticky half-open mark, a failing half-open probe would leave
        the breaker half-open and re-probe every interval)."""
        self._last_probe = self.clock()
        for rep in self.replicas:
            if not rep.alive or rep.retired:
                continue
            if not rep.breaker.allow():
                continue            # open: cooling down — no probe yet
            try:
                rep.probe()
            except Exception as e:
                # duck-typed like every other failover site: ANY
                # replica-fatal error (not just our class) is a death,
                # everything else a transient probe failure for the
                # breaker
                if getattr(e, "replica_fatal", False):
                    self._on_replica_death(rep, e)
                else:
                    rep.breaker.record_failure()
            else:
                rep.breaker.record_success()

    # -- the drive loop ----------------------------------------------------

    def sweep(self) -> bool:
        """ONE drive sweep: probe if due, round-robin one `step()`
        per live replica, mirror outcomes, harvest disagg handoffs,
        redistribute on any replica-fatal error. Returns True while
        the fleet has work — `run()` is just this in a loop, and the
        fleet supervisor interleaves its autoscale/reap ticks at
        exactly this boundary."""
        if self._probe_due():
            self.probe_all()
        busy = False
        # list(): a supervisor callback (autoscale inside a fault
        # hook) may append replicas mid-sweep; they join NEXT sweep
        for rep in list(self.replicas):
            if not rep.alive:
                continue
            try:
                busy = rep.server.step() or busy
            except Exception as e:
                if getattr(e, "replica_fatal", False):
                    self._on_replica_death(rep, e)
                    busy = True     # survivors just got work
                    continue
                raise
            self._mirror(rep)
            if (self._disagg and rep.alive
                    and rep.server.role == "prefill"
                    and rep.server.ready_handoffs()):
                try:
                    # migrations hand the decode tier (or,
                    # cancelled, this replica) new work mid-sweep
                    busy = self._harvest_handoffs(rep) > 0 or busy
                except Exception as e:
                    if getattr(e, "replica_fatal", False):
                        # the SOURCE died with requests parked:
                        # its pinned blocks died with it and no
                        # destination ever committed — both copies
                        # lost, so the parked requests ride the
                        # standard redistribution path (full
                        # re-prefill on a survivor, exactly one
                        # outcome each)
                        self._on_replica_death(rep, e)
                        busy = True
                        continue
                    raise
        return busy

    def run(self) -> Dict[int, RouterResult]:
        """Serve until every replica is idle: `sweep()` in a loop.
        Safe to call repeatedly — later `submit()`s extend the same
        ledger."""
        while self.sweep():
            pass
        return self.results

    # -- observability -----------------------------------------------------

    def bind_metrics(self, registry, *, prefix: str = "fleet",
                     labels: Optional[Dict[str, str]] = None) -> None:
        """Register the fleet ledger (`counters()`, `fleet_*`
        aggregates included) as a read-through source on an
        `obs.MetricsRegistry` — exported numbers and `reconcile()`
        read the same books."""
        registry.register_source(prefix, self.counters, labels=labels)
        if self.tracer is not None:
            registry.register_source(f"{prefix}_trace",
                                     self.tracer.counters,
                                     labels=labels)
        if self.flight is not None:
            registry.register_source(f"{prefix}_flight",
                                     self.flight.counters,
                                     labels=labels)

    def counters(self) -> Dict[str, int]:
        """The fleet ledger (router-level outcome tallies + routing
        and failover counters) plus the AGGREGATE pool/serving
        counters summed across replicas — dead replicas' contributions
        banked at death, so prefix-hit observability survives a
        crash. Per-replica detail: `per_replica()`."""
        out = dict(self.stats)
        out["replicas_alive"] = sum(
            r.alive and not r.retired for r in self.replicas)
        agg: Dict[str, int] = dict(self._dead_base)
        for rep in self.replicas:
            if not rep.alive:
                continue
            for k, v in rep.server.counters().items():
                if k == "acceptance_rate":
                    continue    # a ratio: summing it is meaningless
                agg[k] = agg.get(k, 0) + v
        for k, v in agg.items():
            out[f"fleet_{k}"] = v
        # fleet acceptance from the SUMMED draft ledger (never an
        # average of per-replica rates — replicas with more proposals
        # must weigh more)
        out["fleet_acceptance_rate"] = (
            agg.get("draft_accepted", 0)
            / max(agg.get("draft_proposed", 0), 1))
        return out

    def per_replica(self) -> Dict[int, Dict[str, int]]:
        return {rep.rid: rep.server.counters()
                for rep in self.replicas if rep.alive}

    def prefix_hit_rate(self) -> float:
        """Aggregate replica-local prefix-cache hit rate — the number
        the chaos suite watches recover after a kill redistributes a
        dead cache's traffic onto cold survivors."""
        c = self.counters()
        h = c.get("fleet_prefix_hits", 0)
        m = c.get("fleet_prefix_misses", 0)
        return h / max(h + m, 1)

    def reconcile(self) -> None:
        """The fleet accounting contract, chaos-tested: every
        router-submitted request has EXACTLY ONE terminal outcome
        (`_record` refuses seconds; this asserts none is missing),
        the outcome tallies equal the ledger, nothing is still
        pending anywhere, and every live replica's own books balance
        (`ServingServer.reconcile`, page invariants included)."""
        assert len(self.results) == self.stats["requests"], (
            len(self.results), self.stats["requests"])
        tally = {o: 0 for o in OUTCOMES}
        for res in self.results.values():
            assert res.outcome in OUTCOMES, res
            tally[res.outcome] += 1
        for o in OUTCOMES:
            assert tally[o] == self.stats[o], (
                o, tally[o], self.stats[o])
        assert not self._moved, self._moved
        for rep in self.replicas:
            assert not rep.pending, (
                f"replica {rep.rid} still holds unmirrored requests "
                f"{rep.pending}")
            if rep.alive and not rep.retired:
                rep.server.reconcile()
