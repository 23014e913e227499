"""Cross-process serving fleet: replica processes + elastic supervisor
(port of `paddle_tpu.serve.fleet`; each replica child opens its own CUDA
context and serves the port's `DecodeEngine` on the card).

`ServingRouter` makes replica LOSS survivable; this module makes the
replicas worth losing. Each fleet member runs its `ServingServer` in
its own OS process (`ReplicaProcess` -> `serve.transport`), so a
SIGKILL, a segfaulting extension, or an OOM takes out ONE replica's
address space instead of the fleet — the paper's v2 master/pserver
tier survived trainer and shard death the same way, by putting the
blast radius behind a process boundary. Engine bundles
(`serve.artifact`) let a replica boot from exported programs, and the
processes are ELASTIC: `FleetSupervisor` spawns against measured load,
reaps idle replicas back to the floor, and rolls the fleet onto a new
artifact one drained replica at a time.

The pieces:

- **`ReplicaSpec`** — a picklable recipe for one replica: a
  `"module:function"` builder the CHILD imports and calls to
  construct its `ServingServer` (optionally booting
  `artifact_path=...` from an engine bundle), the torch device it
  serves on (`device`, default cuda), plus transport knobs. The
  recipe crosses the spawn boundary; live objects never do.

- **`ReplicaProcess`** — one spawned child (spawn context: CUDA
  cannot be used after a fork, and the parent holds a context of its
  own). For a CUDA replica the PARENT builds the serving kernels
  (`SERVING_KERNELS`) before it spawns, so children only load the
  cached libraries and never run nvcc at once. The child resolves its
  device (no card is an error: it never goes on on the CPU), loads the
  kernel libraries, builds the server, places the engine's arenas on
  the device, sends `("ready", addr)` up the pipe, and serves; a
  failure anywhere in that boot kills the child and `wait_ready`
  raises. Two layers of orphan protection, because a SIGKILLed
  supervisor runs no cleanup: the child parks a watchdog thread on
  the pipe — the kernel closes the supervisor's end at death, the
  blocked `recv` raises, the child `os._exit`s — and the process is
  `daemon=True` besides. A supervisor that dies WITHOUT drain
  therefore leaves no orphan decoding into the void.

- **`FleetSupervisor`** — spawn/reap lifecycle + autoscaling +
  rolling upgrades over a `ServingRouter`. One `sweep()` = one
  router sweep (step every live replica, mirror outcomes) + one
  autoscale tick + one reap pass; `run()` sweeps until the fleet is
  idle. Scale-out triggers on mean queue depth per routable replica
  or a p99 latency bound (`AutoscalePolicy`), and ALSO whenever
  deaths drop the routable count below the floor — which is exactly
  the SIGKILL-recovery path: the router redistributes the dead
  replica's ledger, the supervisor notices the hole and spawns the
  replacement. Scale-in retires (never kills) the youngest idle
  replica: `retire_replica` hands its queue to survivors, in-flight
  work finishes in place, and only an EMPTY replica is shut down and
  reaped — zero dropped, zero duplicated outcomes across scale
  events, the same exactly-once books the chaos suite asserts.

The module loads torch and the serving stack on first use, so an agent
process, which only spawns and fences replicas, never imports them.

Autoscale decisions count SWEEPS, not seconds: the drive loop is
synchronous, so sweeps are the deterministic time base the tests and
`ManualClock` runs share with production (where a sweep's wall time
is the step cadence anyway).
"""

from __future__ import annotations

import atexit
import dataclasses
import importlib
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from paddle_tpu_torch.obs.flight import FlightRecorder
from paddle_tpu_torch.obs.registry import MetricsRegistry

# torch and the serving stack (router, transport, server) load on first
# use: a process that only spawns and fences replicas -- the per-host
# agent -- never imports them; its replica children do

__all__ = ["AutoscalePolicy", "FleetSupervisor", "ReplicaProcess",
           "ReplicaSpec", "build_server_from_config"]

#: child exit codes, visible in `ReplicaProcess.exitcode()` and the
#: supervisor's flight records
EXIT_OK = 0             # served until shutdown, exited cleanly
EXIT_ORPHANED = 17      # parent-death watchdog fired

#: the kernel libraries a serving replica launches (A; B and C)
SERVING_KERNELS = ("flash_attention", "ragged_paged_attention")


@dataclasses.dataclass
class ReplicaSpec:
    """Everything a child process needs to become a replica. Must
    stay picklable (it crosses the spawn boundary): the builder is an
    IMPORT PATH, its kwargs plain data — an engine artifact path, a
    config dict, a seed — never live objects."""

    builder: str                        # "package.module:function"
    kwargs: dict = dataclasses.field(default_factory=dict)
    device: str = "cuda"                # the torch device it serves on
    host: str = "127.0.0.1"
    port: int = 0                       # 0 = kernel-assigned
    env: dict = dataclasses.field(default_factory=dict)
    connect_timeout: float = 1.0
    io_timeout: float = 30.0
    retries: int = 8

    def build_server(self):
        """Import the builder and call it with `kwargs` and
        `device=self.device` (the spec's device is the only one: a
        `device` in kwargs is refused)."""
        mod, _, fn = self.builder.partition(":")
        if not fn:
            raise ValueError(
                f"builder must be 'module:function', got "
                f"{self.builder!r}")
        if "device" in self.kwargs:
            raise ValueError(
                "ReplicaSpec.kwargs must not name a device: set "
                "ReplicaSpec.device")
        return getattr(importlib.import_module(mod), fn)(
            **self.kwargs, device=self.device)


def build_server_from_config(*, config: str, slots=None, max_len=None,
                             seed: int = 0, max_queue: int = 64,
                             default_deadline_ms=None,
                             max_retries: int = 1, buckets=None,
                             drain_grace_s: float = 30.0,
                             artifact: Optional[str] = None,
                             role: str = "unified",
                             page_size=None, prefill_chunk=None,
                             data_plane: Optional[str] = None,
                             device: str = "cuda"):
    """The `cli serve --fleet-procs` replica builder: run the user's
    serve-config script IN THE CHILD (each process owns its engine
    pool; no tensor crosses the spawn boundary) and wrap the engine in
    the reliability server, optionally booted from an engine bundle.
    Kwargs mirror the `serve` CLI knobs — all plain data, as
    `ReplicaSpec` requires: `data_plane` is the NAME of the
    supervisor's shared-memory arena (the child attaches; an attach
    failure degrades to the pickle path inside `ServingServer`),
    `role` makes disaggregated prefill/decode tiers spawnable, and the
    engine serves on `device` (the config's parameters are moved
    there)."""
    import runpy

    from paddle_tpu_torch.core.devices import resolve_device
    from paddle_tpu_torch.core.pytree import tree_map
    from paddle_tpu_torch.serve.engine import DecodeEngine
    from paddle_tpu_torch.serve.server import ServingServer

    ns = runpy.run_path(config)
    if "get_serve_config" not in ns:
        raise ValueError(
            f"{config} must define get_serve_config()")
    sc = ns["get_serve_config"]()
    dev = resolve_device(device)
    engine = DecodeEngine(
        tree_map(lambda t: t.to(dev), sc["params"]), sc["cfg"],
        slots=(sc.get("slots", 8) if slots is None else slots),
        max_len=(sc.get("max_len", 2048) if max_len is None
                 else max_len),
        page_size=(sc.get("page_size", 16) if page_size is None
                   else page_size),
        prefill_chunk=(sc.get("prefill_chunk") if prefill_chunk
                       is None else prefill_chunk),
        eos_id=sc.get("eos_id"), seed=seed, device=dev)
    return ServingServer(
        engine, max_queue=max_queue,
        default_deadline_ms=default_deadline_ms,
        max_retries=max_retries,
        buckets=tuple(buckets) if buckets else None,
        drain_grace_s=drain_grace_s, artifact_path=artifact,
        role=role, data_plane=data_plane)


def build_serving_kernels(device) -> None:
    """Parent side of a CUDA replica's boot: build the serving kernel
    libraries (one nvcc per source, all at once) BEFORE any child is
    spawned, so children find the cached build and never compile. A
    no-op for a CPU replica."""
    if str(device).split(":")[0] == "cuda":
        from paddle_tpu_torch.ops import _cuda

        _cuda.build_all(SERVING_KERNELS)


def _load_serving_kernels() -> None:
    """Child side: load the kernel libraries the parent built (their
    C entries declared), refusing to compile here -- several children
    booting at once must not each run nvcc."""
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import ragged_paged_attention as RPA

    sigs = {"flash_attention": FA._SIGNATURES,
            "ragged_paged_attention": RPA._SIGNATURES}
    for name in SERVING_KERNELS:
        if not _cuda.library_path(name).exists():
            raise RuntimeError(
                f"kernel library {name} is not built: the parent builds "
                f"the serving kernels before it spawns a CUDA replica")
        _cuda.library(name, sigs[name])


def _place_on_device(server, device: str) -> None:
    """Build the server's engine state now, so its arenas sit on
    `device` before the replica reports ready (a server builds its pool
    lazily otherwise). A replica without an engine pool (a test's idle
    server) has nothing to place."""
    engine = getattr(server, "engine", None)
    if engine is None or not hasattr(engine, "init_state"):
        return
    import torch

    device = torch.device(device)

    def same(d) -> bool:
        d = torch.device(d)
        return d.type == device.type and (
            d.index is None or device.index is None
            or d.index == device.index)

    if not same(engine.device):
        raise RuntimeError(
            f"replica engine serves on {engine.device}, its spec on "
            f"{device}")
    if server._state is None:
        server._reset_pool()
    leaf = server._state.caches[0][0]
    leaf = leaf[0] if isinstance(leaf, tuple) else leaf
    if not same(leaf.device):
        raise RuntimeError(
            f"replica arenas on {leaf.device}, its spec on {device}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _replica_main(spec: ReplicaSpec, conn) -> None:
    """Child entrypoint (top-level so spawn can import it by name).
    Boot order matters: the device FIRST (no card for a CUDA spec is
    an error, never a quiet CPU replica), then the kernel libraries
    and the server with its arenas on the device, the ready handshake
    only after the listener is bound (the supervisor connects the
    moment it hears the address), the watchdog before serving (a
    supervisor can die while we boot)."""
    from paddle_tpu_torch.serve.transport import ReplicaTransportServer

    os.environ.update(spec.env)
    if spec.device != "cpu":
        from paddle_tpu_torch.core.devices import resolve_device

        if resolve_device(spec.device).type == "cuda":
            _load_serving_kernels()
    server = spec.build_server()
    _place_on_device(server, spec.device)
    transport = ReplicaTransportServer(server, host=spec.host,
                                       port=spec.port)

    def _watchdog() -> None:
        # the supervisor holds the pipe's other end and never writes:
        # recv() returns only when that end closes — normally at
        # supervisor exit (atexit reap), abruptly when the kernel
        # closes the fds of a SIGKILLed supervisor. Either way this
        # child must not keep decoding into the void.
        try:
            conn.recv()
        except (EOFError, OSError):
            pass
        os._exit(EXIT_ORPHANED)

    conn.send(("ready", transport.addr))
    threading.Thread(target=_watchdog, daemon=True).start()
    transport.serve_forever()
    os._exit(EXIT_OK)       # shutdown op: skip atexit/CUDA teardown


class ReplicaProcess:
    """Handle on one spawned replica child: boot handshake, liveness,
    and the kill/reap lifecycle the supervisor (and the fencing path
    in `ProcessReplica._fatal`) drives."""

    def __init__(self, spec: ReplicaSpec, *, ctx=None):
        import multiprocessing
        self.spec = spec
        ctx = ctx or multiprocessing.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self.proc = ctx.Process(target=_replica_main,
                                args=(spec, child_conn), daemon=True)
        self._child_conn = child_conn
        self.addr: Optional[Tuple[str, int]] = None

    def start(self) -> "ReplicaProcess":
        build_serving_kernels(self.spec.device)
        self.proc.start()
        # the child inherited its copy; ours must close or the
        # watchdog's EOF would wait on US holding the write end open
        self._child_conn.close()
        return self

    def wait_ready(self, timeout_s: float = 120.0) -> Tuple[str, int]:
        """Block for the child's `("ready", addr)` handshake. A child
        that dies while booting fails fast here instead of eating the
        whole timeout."""
        deadline = time.monotonic() + timeout_s
        while True:
            if self._conn.poll(0.2):
                try:
                    tag, addr = self._conn.recv()
                except (EOFError, OSError) as e:
                    raise RuntimeError(
                        f"replica child pid={self.proc.pid} died "
                        f"during boot (exitcode="
                        f"{self.proc.exitcode})") from e
                assert tag == "ready", tag
                self.addr = (addr[0], int(addr[1]))
                return self.addr
            if not self.proc.is_alive():
                raise RuntimeError(
                    f"replica child pid={self.proc.pid} exited "
                    f"during boot (exitcode={self.proc.exitcode})")
            if time.monotonic() > deadline:
                self.kill()
                raise TimeoutError(
                    f"replica child pid={self.proc.pid} not ready "
                    f"after {timeout_s}s")

    def alive(self) -> bool:
        return self.proc.is_alive()

    def exitcode(self) -> Optional[int]:
        return self.proc.exitcode

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid

    def kill(self) -> None:
        """SIGKILL — the fencing path (never graceful). Idempotent
        and safe on an already-dead child."""
        if self.proc.is_alive():
            self.proc.kill()

    def reap(self, timeout_s: float = 10.0) -> Optional[int]:
        """Join, escalating to SIGKILL if the child won't die, and
        release the pipe. Returns the exit code."""
        self.proc.join(timeout_s)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout_s)
        self._conn.close()
        return self.proc.exitcode


@dataclasses.dataclass
class AutoscalePolicy:
    """When to scale, in SWEEPS (the fleet's deterministic time
    base). Scale-out: mean load (queued + in-flight) per routable
    replica above `queue_high`, or observed p99 latency above
    `p99_high_ms` (None = queue-depth only). Scale-in: `idle_sweeps`
    consecutive sweeps with zero fleet load. `cooldown_sweeps`
    separates ANY two scale events so one burst can't thrash the
    fleet through spawn/reap cycles."""

    queue_high: float = 2.0
    p99_high_ms: Optional[float] = None
    idle_sweeps: int = 8
    cooldown_sweeps: int = 4

    def decide(self, *, mean_load: float, p99_ms: Optional[float],
               idle_streak: int, since_event: int, n_routable: int,
               floor: int, ceiling: int) -> Optional[str]:
        if n_routable < floor:
            return "out"        # repair below the floor — no cooldown
        if since_event < self.cooldown_sweeps:
            return None
        if n_routable < ceiling:
            if mean_load > self.queue_high:
                return "out"
            if (self.p99_high_ms is not None and p99_ms is not None
                    and p99_ms > self.p99_high_ms):
                return "out"
        if idle_streak >= self.idle_sweeps and n_routable > floor:
            return "in"
        return None


class FleetSupervisor:
    """Own the replica processes a `ServingRouter` fronts.

    `start()` boots `min_replicas` children in parallel and builds
    the router over their `ProcessReplica` adapters; `submit()` and
    `run()` drive traffic exactly like a bare router, with an
    autoscale tick and a reap pass folded into every sweep. The
    supervisor is the ONLY owner of child lifecycle: the router
    decides who is routable, the supervisor decides who exists.

    `spawn` is the test seam: given a `ReplicaSpec`, return any
    server duck type (default: spawn a real `ReplicaProcess` and wrap
    its socket in `ProcessReplica`). In-process tests inject a
    builder-calling lambda and exercise every lifecycle path without
    paying process boots."""

    def __init__(self, spec: ReplicaSpec, *,
                 min_replicas: int = 1,
                 max_replicas: int = 4,
                 policy: Optional[AutoscalePolicy] = None,
                 spawn: Optional[Callable[[ReplicaSpec], object]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 boot_timeout_s: float = 120.0,
                 flight: Optional[FlightRecorder] = None,
                 flight_dir: Optional[str] = None,
                 router_kwargs: Optional[dict] = None,
                 membership: Optional[object] = None,
                 data_plane_segs: int = 0,
                 data_plane_seg_kb: int = 256):
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        self.spec = spec
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.clock = clock
        self.boot_timeout_s = boot_timeout_s
        self.flight = flight
        self.flight_dir = flight_dir
        self._spawn_fn = spawn
        self._router_kwargs = dict(router_kwargs or {})
        # membership mode (`cluster.membership` service/client duck
        # type): the fleet roster is RESOLVED from the membership
        # view — replicas live on per-host agents, host death
        # arrives as a view change, and autoscaling is the agents'
        # business, not ours. `None` = classic single-host mode
        # (supervisor owns the processes), untouched.
        self.membership = membership
        self._mem_epoch = 0
        #: (host_id, (addr, port)) -> rid, the roster the view diffs
        #: against
        self._known_eps: Dict[Tuple[str, Tuple[str, int]], int] = {}
        self.router: Optional[ServingRouter] = None
        self.procs: Dict[int, Optional[ReplicaProcess]] = {}
        self._retiring: set = set()
        self._idle_streak = 0
        self._since_scale = 0
        self.stats: Dict[str, int] = {
            "spawned": 0, "reaped": 0, "scale_out_events": 0,
            "scale_in_events": 0, "upgrades": 0, "view_changes": 0,
            "hosts_lost": 0, "replicas_joined": 0}
        self.registry = (registry if registry is not None
                         else MetricsRegistry(clock=clock))
        # completion latency (ms) for requests routed through
        # `submit()` — the p99 the autoscaler reads
        self._latency = self.registry.histogram(
            "fleet_latency_ms", "fleet request completion latency",
            buckets=(1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0,
                     5000.0, 30000.0, float("inf")))
        self._submitted_at: Dict[int, float] = {}
        self._latency_seen: set = set()
        self._closed = False
        self._atexit_registered = False
        # zero-copy data plane (serve.shm_arena): the supervisor
        # CREATES the fleet-shared arena and injects its NAME into
        # the spec's builder kwargs — children attach by name and
        # migrations move KV bytes through shared memory instead of
        # pickling them through the control socket. Opt-in
        # (data_plane_segs > 0); a create failure (no /dev/shm)
        # degrades to the pickle path fleetwide with a flight event.
        self.arena = None
        if data_plane_segs > 0:
            from paddle_tpu_torch.serve.shm_arena import (ArenaError,
                                                    ShmArena)
            try:
                self.arena = ShmArena(
                    seg_size=data_plane_seg_kb * 1024,
                    n_segs=data_plane_segs)
                self.spec = dataclasses.replace(
                    self.spec,
                    kwargs={**self.spec.kwargs,
                            "data_plane": self.arena.name})
            except ArenaError as e:
                self._note("data-plane-unavailable", error=repr(e))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetSupervisor":
        """Boot the floor fleet (children boot in PARALLEL — start
        them all, then collect handshakes) and build the router."""
        from paddle_tpu_torch.serve.router import ServingRouter

        assert self.router is None, "start() is once"
        members: List[Tuple[object, Optional[ReplicaProcess]]] = []
        mem_eps: List[Tuple[str, Tuple[str, int]]] = []
        if self.membership is not None:
            view = self.membership.view()
            self._mem_epoch = view.epoch
            mem_eps = view.endpoints("replicas")
            if not mem_eps:
                raise RuntimeError(
                    "membership view (epoch "
                    f"{view.epoch}) carries no replica endpoints — "
                    "are the host agents registered?")
            for _, addr in mem_eps:
                members.append((self._wrap_addr(addr), None))
        elif self._spawn_fn is not None:
            for _ in range(self.min_replicas):
                members.append((self._spawn_fn(self.spec), None))
        else:
            procs = [ReplicaProcess(self.spec).start()
                     for _ in range(self.min_replicas)]
            for proc in procs:
                proc.wait_ready(self.boot_timeout_s)
                members.append((self._wrap(proc), proc))
        self.router = ServingRouter(
            [server for server, _ in members],
            clock=self.clock, flight=self.flight,
            flight_dir=self.flight_dir, **self._router_kwargs)
        for rid, (_, proc) in enumerate(members):
            self.procs[rid] = proc
        for rid, (host_id, addr) in enumerate(mem_eps):
            self._known_eps[(host_id, addr)] = rid
        self.stats["spawned"] += len(members)
        self.router.bind_metrics(self.registry)
        self.registry.register_source("fleet_sup", self.counters)
        if self.arena is not None:
            self.arena.bind_metrics(self.registry)
        if not self._atexit_registered:
            # a supervisor that exits WITHOUT shutdown() still reaps:
            # children also carry their own watchdog for the SIGKILL
            # case atexit can't cover
            atexit.register(self._atexit_shutdown)
            self._atexit_registered = True
        self._note("fleet-start", replicas=self.min_replicas)
        return self

    def _wrap(self, proc: ReplicaProcess) -> "ProcessReplica":
        from paddle_tpu_torch.serve.transport import (ProcessReplica,
                                                      ReplicaClient)

        client = ReplicaClient(
            proc.addr,
            connect_timeout=self.spec.connect_timeout,
            io_timeout=self.spec.io_timeout,
            retries=self.spec.retries)
        return ProcessReplica(client, proc=proc, clock=self.clock)

    def _wrap_addr(self, addr: Tuple[str, int]) -> "ProcessReplica":
        """An agent-owned replica: we hold its SOCKET, never its
        process (proc=None — fencing degrades to transport-only; the
        owning agent, or its death, is what actually stops it)."""
        from paddle_tpu_torch.serve.transport import (ProcessReplica,
                                                      ReplicaClient)

        client = ReplicaClient(
            (addr[0], int(addr[1])),
            connect_timeout=self.spec.connect_timeout,
            io_timeout=self.spec.io_timeout,
            retries=self.spec.retries)
        return ProcessReplica(client, proc=None, clock=self.clock)

    def _spawn_member(self, spec: ReplicaSpec) -> int:
        """Spawn one replica (process or seam) and add it to the
        router's sweep. Returns the new rid."""
        if self._spawn_fn is not None:
            server, proc = self._spawn_fn(spec), None
        else:
            proc = ReplicaProcess(spec).start()
            proc.wait_ready(self.boot_timeout_s)
            server = self._wrap(proc)
        rid = self.router.add_replica(server)
        self.procs[rid] = proc
        self.stats["spawned"] += 1
        self._note("replica-spawn", rid=rid,
                   pid=None if proc is None else proc.pid)
        return rid

    def _note(self, what: str, **fields) -> None:
        if self.flight is not None:
            self.flight.record("fleet", what, **fields)

    # -- traffic (thin router delegates) -----------------------------------

    def submit(self, prompt, *, max_new: int, deadline_ms=-1,
               sampling: Optional[dict] = None) -> int:
        rr_id = self.router.submit(prompt, max_new=max_new,
                                   deadline_ms=deadline_ms,
                                   sampling=sampling)
        self._submitted_at[rr_id] = self.clock()
        return rr_id

    def sweep(self) -> bool:
        """One supervisor turn: drive the fleet, feed the latency
        histogram, tick the autoscaler, reap empty retirees. In
        membership mode the VIEW ticks first — a host the membership
        evicted is fenced before this sweep would step its replicas
        (redistribution from the view change, not from a socket
        error) — and the autoscale tick is skipped: capacity belongs
        to the per-host agents."""
        if self.membership is not None:
            self._membership_tick()
        busy = self.router.sweep()
        self._observe_latency()
        if self.membership is None:
            self._autoscale_tick()
        self._reap_retired()
        if self.arena is not None:
            # orphan-reclaim ride-along: a SIGKILLed child's in-
            # flight segments free here, on the same tick that fences
            # and redistributes its requests
            n = self.arena.reclaim_orphans()
            if n:
                self._note("data-plane-reclaim", segments=n)
        return busy

    def _membership_tick(self) -> None:
        """Fold the current membership view into the fleet roster:
        endpoints that LEFT (host eviction, inventory shrink) run
        the router's crash path; endpoints that JOINED are added to
        the next sweep. A membership outage is tolerated — the fleet
        keeps serving the last view it saw."""
        try:
            self.membership.tick()
            view = self.membership.view()
        except (OSError, ConnectionError, RuntimeError):
            return
        if view.epoch == self._mem_epoch:
            return
        self._mem_epoch = view.epoch
        self.stats["view_changes"] += 1
        current = set()
        for host_id, addr in view.endpoints("replicas"):
            key = (host_id, addr)
            current.add(key)
            if key not in self._known_eps:
                rid = self.router.add_replica(self._wrap_addr(addr))
                self.procs[rid] = None
                self._known_eps[key] = rid
                self.stats["replicas_joined"] += 1
                self._note("replica-join", rid=rid, host=host_id,
                           epoch=view.epoch)
        lost_hosts = set()
        for key in [k for k in self._known_eps if k not in current]:
            host_id, _ = key
            rid = self._known_eps.pop(key)
            lost_hosts.add(host_id)
            self.router.declare_dead(
                rid, f"host {host_id} left the membership view "
                     f"(epoch {view.epoch})")
            self._note("replica-left", rid=rid, host=host_id,
                       epoch=view.epoch)
        self.stats["hosts_lost"] += sum(
            1 for h in lost_hosts
            if not any(k[0] == h for k in self._known_eps))

    def run(self):
        """Serve until the fleet is idle (the router contract);
        autoscaling runs inside every sweep, so a mid-run death is
        repaired and a mid-run spike scales out without the caller
        doing anything."""
        while self.sweep():
            pass
        return self.router.results

    def drain(self, reason: str = "fleet drain") -> None:
        self.router.drain(reason=reason)

    def counters(self) -> Dict[str, int]:
        out = dict(self.stats)
        out["procs_alive"] = sum(
            1 for p in self.procs.values()
            if p is not None and p.alive())
        out["replicas_routable"] = sum(
            1 for r in self.router.replicas if r.routable())
        for rid, proc in self.procs.items():
            if proc is not None:
                out[f"proc_r{rid}_alive"] = int(proc.alive())
        if self.membership is not None:
            out["membership_epoch"] = self._mem_epoch
            out["hosts_live"] = len({h for h, _ in self._known_eps})
        if self.arena is not None:
            out.update(self.arena.counters())
        return out

    def reconcile(self) -> None:
        self.router.reconcile()
        if self.arena is not None:
            # the fleet is quiescent (the router's books just
            # balanced): after reclaiming any dead owners' segments,
            # the arena must hold NOTHING — every ticket was freed on
            # ACK/cancel or reclaimed with its owner
            self.arena.reclaim_orphans()
            self.arena.reconcile()

    # -- autoscaling -------------------------------------------------------

    def _observe_latency(self) -> None:
        now = self.clock()
        for rr_id in list(self._submitted_at):
            if rr_id in self.router.results:
                t0 = self._submitted_at.pop(rr_id)
                self._latency.observe((now - t0) * 1000.0)

    def _routable(self) -> list:
        return [r for r in self.router.replicas if r.routable()]

    def _autoscale_tick(self) -> None:
        self._since_scale += 1
        routable = self._routable()
        loads = [r.load() for r in routable]
        total = sum(loads)
        self._idle_streak = self._idle_streak + 1 if total == 0 else 0
        verdict = self.policy.decide(
            mean_load=total / max(len(loads), 1),
            p99_ms=self._latency.quantile(0.99),
            idle_streak=self._idle_streak,
            since_event=self._since_scale,
            n_routable=len(routable),
            floor=self.min_replicas, ceiling=self.max_replicas)
        if verdict == "out":
            self.scale_out()
        elif verdict == "in":
            self.scale_in()

    def scale_out(self) -> int:
        """Add one replica NOW (autoscaler verdict or operator
        call). Resets the cooldown clock."""
        if self.membership is not None:
            raise RuntimeError(
                "capacity is agent-owned in membership mode — "
                "add a host (or grow an agent's inventory) instead")
        rid = self._spawn_member(self.spec)
        self.stats["scale_out_events"] += 1
        self._since_scale = 0
        self._note("scale-out", rid=rid,
                   routable=len(self._routable()))
        return rid

    def scale_in(self) -> Optional[int]:
        """Retire the youngest idle routable replica (never below
        the floor). Retirement redistributes its queue and lets
        in-flight work finish; the reap pass shuts the process down
        only once it is EMPTY — zero dropped outcomes by
        construction."""
        if self.membership is not None:
            raise RuntimeError(
                "capacity is agent-owned in membership mode — "
                "deregister the host instead")
        routable = self._routable()
        if len(routable) <= self.min_replicas:
            return None
        idle = [r for r in routable if r.load() == 0
                and r.rid not in self._retiring]
        if not idle:
            return None
        victim = max(idle, key=lambda r: r.rid)
        self.router.retire_replica(victim.rid, reason="scale-in")
        self._retiring.add(victim.rid)
        self.stats["scale_in_events"] += 1
        self._since_scale = 0
        self._idle_streak = 0
        self._note("scale-in", rid=victim.rid)
        return victim.rid

    def _reap_retired(self) -> None:
        for rid in sorted(self._retiring):
            rep = self.router.replicas[rid]
            if rep.alive and (rep.pending or rep.server.load() > 0):
                continue        # still finishing in place
            self._retiring.discard(rid)
            self._shutdown_member(rid)
            if rep.alive:
                self.router.reap_replica(rid)
            self.stats["reaped"] += 1
            self._note("replica-reap", rid=rid)

    def _shutdown_member(self, rid: int) -> None:
        rep = self.router.replicas[rid]
        proc = self.procs.get(rid)
        shutdown = getattr(rep.server, "shutdown", None)
        if shutdown is not None and (proc is None or proc.alive()):
            try:
                shutdown()
            except Exception:
                pass            # the reap below is the enforcement
        if proc is not None:
            proc.reap()
            self.procs[rid] = None

    # -- rolling upgrades --------------------------------------------------

    def rolling_upgrade(self, new_spec: ReplicaSpec,
                        *, max_sweeps: int = 100000) -> None:
        """Move the fleet to `new_spec` one replica at a time:
        replacement FIRST (capacity never dips), then retire the old
        replica — its queue redistributes (nothing sheds: the
        replacement just added headroom) and its in-flight work
        finishes in place — then sweep until it is empty, shut it
        down, reap it. An interrupted upgrade (exception, supervisor
        death) leaves a fleet of mixed versions that is fully
        serviceable: every member is either drained-and-gone or
        live."""
        old_rids = [r.rid for r in self.router.replicas
                    if r.alive and not r.retired]
        for rid in old_rids:
            self._spawn_member(new_spec)
            self.router.retire_replica(
                rid, reason=f"rolling upgrade of r{rid}")
            rep = self.router.replicas[rid]
            for _ in range(max_sweeps):
                if not rep.alive or (not rep.pending
                                     and rep.server.load() == 0):
                    break
                self.router.sweep()
            self._shutdown_member(rid)
            if rep.alive:
                self.router.reap_replica(rid)
            self.stats["reaped"] += 1
            self._note("upgrade-step", rid=rid)
        self.spec = new_spec
        self.stats["upgrades"] += 1
        self._note("upgrade-done", replicas=len(self._routable()))

    # -- shutdown ----------------------------------------------------------

    def _atexit_shutdown(self) -> None:
        try:
            self.shutdown(drain=False)
        except Exception:
            pass                # atexit must never raise

    def shutdown(self, *, drain: bool = True) -> None:
        """Stop the fleet: optional graceful drain (finish in-flight
        within each replica's grace), then shut down and reap every
        child. Idempotent; also registered atexit so a supervisor
        that simply exits leaves no processes behind."""
        if self._closed:
            return
        self._closed = True
        if self.router is not None:
            if drain:
                try:
                    self.router.drain(reason="fleet shutdown")
                    self.run()
                except Exception:
                    pass        # shutdown continues regardless
            for rid in list(self.procs):
                self._shutdown_member(rid)
        if self.arena is not None:
            self.arena.close(destroy=True)
        if self._atexit_registered:
            atexit.unregister(self._atexit_shutdown)
            self._atexit_registered = False
        self._note("fleet-stop")
