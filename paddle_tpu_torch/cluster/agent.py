"""The per-host agent: local spawn/fence + a membership lease (port of
`paddle_tpu.cluster.agent`, the JAX module over the port's
`serve.fleet` and `cluster.membership`).

`FleetSupervisor` owns replica processes DIRECTLY — fork,
waitpid, /proc — which only works when the supervisor and the
replicas share a box. The agent is the host-local half of that split:
one agent per host owns the processes ON that host, and everything
above the host boundary sees only membership state:

- boot: spawn this host's replicas (`serve.fleet.ReplicaProcess` —
  the agent is just another parent to them), register the host with
  membership carrying the replicas' endpoints as inventory, then
  renew the lease forever.
- death: the supervisor learns of it as a LEASE EXPIRY → view
  change, never as a waitpid. The agent's replicas die with it: each
  replica child parks its watchdog on the pipe to the AGENT, and the
  agent parks its own watchdog on the pipe to the SUPERVISOR, so a
  SIGKILLed supervisor takes the whole chain down —
  supervisor dies → agent's pipe EOFs → agent exits → the replicas'
  pipes EOF → replicas exit. No layer survives its parent.
- eviction: a renew refused (``expired`` after a missed TTL,
  ``stale_epoch`` after the cluster moved on while the agent was
  paused) means this host is no longer IN the cluster — the agent
  executes fenced teardown: SIGKILL its replicas, exit. It must
  never keep capacity alive that the view says does not exist, and
  its writes could not land anyway (the epoch fence refuses them).

Multi-host on one box: N agent processes with distinct fake host-ids
— exactly how the chaos tests run it.

The agent process itself never touches the card (its replica
CHILDREN do, each with a CUDA context of its own).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch.serve.fleet import ReplicaProcess, ReplicaSpec

__all__ = ["AgentProcess", "AgentSpec", "EXIT_EVICTED",
           "EXIT_AGENT_ORPHANED"]

#: agent exit codes (the supervisor's flight records and the chaos
#: suite read these)
EXIT_AGENT_ORPHANED = 18    # parent-death watchdog fired
EXIT_EVICTED = 19           # membership fenced us out (or vanished)


@dataclasses.dataclass
class AgentSpec:
    """Everything one agent child needs. Picklable (crosses the spawn
    boundary): the replica recipe is a `ReplicaSpec`, the membership
    address plain data."""

    host_id: str
    replica_spec: ReplicaSpec
    n_replicas: int = 1
    #: None = run leaseless (lifecycle tests that only need the
    #: orphan chain); otherwise the membership server's address
    membership_addr: Optional[Tuple[str, int]] = None
    ttl_s: float = 10.0
    renew_interval_s: float = 0.5
    #: fold self-counters into inventory every N renews
    report_every: int = 20
    boot_timeout_s: float = 120.0
    env: dict = dataclasses.field(default_factory=dict)


def _agent_main(spec: AgentSpec, conn) -> None:
    """Child entrypoint (top-level so spawn imports it by name).
    Order matters, same as `_replica_main`: replicas first (their
    endpoints ARE our inventory), then register, then the ready
    handshake, then the watchdog before the renew loop."""
    os.environ.update(spec.env)
    counters: Dict[str, int] = {"replicas_spawned": 0, "renews": 0,
                                "renews_refused": 0, "reports": 0}
    replicas: List[ReplicaProcess] = []

    def _fence_local(code: int) -> None:
        # fenced teardown: SIGKILL, never graceful — an evicted
        # host's replicas must not finish writes the cluster already
        # redistributed elsewhere
        for rp in replicas:
            try:
                rp.kill()
            except Exception:
                pass
        os._exit(code)

    def _watchdog() -> None:
        # the supervisor holds the other end: a recv returns a
        # ("stop",) for graceful teardown, or EOF when the
        # supervisor died (kernel-closed fds after SIGKILL)
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                _fence_local(EXIT_AGENT_ORPHANED)
            if msg and msg[0] == "stop":
                _fence_local(0)

    try:
        for _ in range(spec.n_replicas):
            rp = ReplicaProcess(spec.replica_spec).start()
            rp.wait_ready(spec.boot_timeout_s)
            replicas.append(rp)
            counters["replicas_spawned"] += 1
    except BaseException as e:
        conn.send(("error", f"{type(e).__name__}: {e}"))
        _fence_local(1)

    endpoints = [[rp.addr[0], rp.addr[1]] for rp in replicas]
    pids = [rp.pid for rp in replicas]

    def inventory() -> dict:
        return {"replicas": endpoints, "pids": pids,
                "counters": dict(counters)}

    token = epoch = None
    client = None
    if spec.membership_addr is not None:
        from paddle_tpu_torch.cluster.membership import MembershipClient
        client = MembershipClient(spec.membership_addr)
        try:
            reg = client.register(spec.host_id, inventory(),
                                  ttl_s=spec.ttl_s)
        except (OSError, ConnectionError) as e:
            conn.send(("error", f"membership register failed: {e}"))
            _fence_local(1)
        token, epoch = reg["token"], reg["epoch"]

    conn.send(("ready", {"host_id": spec.host_id,
                         "replicas": endpoints, "pids": pids,
                         "agent_pid": os.getpid(),
                         "token": token, "epoch": epoch}))
    threading.Thread(target=_watchdog, daemon=True).start()

    if client is None:
        # leaseless mode: nothing to renew; park on the watchdog
        threading.Event().wait()

    # -- the renew loop: the agent's whole steady state ------------------
    last_ok = time.monotonic()
    renews_since_report = 0
    while True:
        time.sleep(spec.renew_interval_s)
        try:
            resp = client.renew(spec.host_id, token, epoch)
        except (OSError, ConnectionError):
            # membership unreachable: tolerate up to one TTL (a
            # primary failover window), then self-fence — we cannot
            # prove we are still in the view, so we must not act as
            # if we were
            if time.monotonic() - last_ok > spec.ttl_s:
                _fence_local(EXIT_EVICTED)
            continue
        if resp["status"] != "ok":
            # evicted or fenced: the cluster moved on without us
            counters["renews_refused"] += 1
            _fence_local(EXIT_EVICTED)
        counters["renews"] += 1
        last_ok = time.monotonic()
        epoch = resp["epoch"]       # ride along with view changes
        renews_since_report += 1
        if renews_since_report >= spec.report_every:
            renews_since_report = 0
            try:
                r = client.report(spec.host_id, token, epoch,
                                  inventory())
                if r["status"] == "ok":
                    counters["reports"] += 1
                    epoch = r["epoch"]
                else:
                    _fence_local(EXIT_EVICTED)
            except (OSError, ConnectionError):
                pass                # the renew loop handles loss


class AgentProcess:
    """Supervisor-side handle on one agent child — the same
    start/wait_ready/kill/reap lifecycle as `ReplicaProcess`, plus
    `stop()` for graceful teardown. NOT a daemon process: daemonic
    children may not have children of their own, and the agent's
    whole job is its replica grandchildren — orphan protection is
    the watchdog chain instead."""

    def __init__(self, spec: AgentSpec, *, ctx=None):
        import multiprocessing
        self.spec = spec
        ctx = ctx or multiprocessing.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self.proc = ctx.Process(target=_agent_main,
                                args=(spec, child_conn), daemon=False)
        self._child_conn = child_conn
        self.info: Optional[dict] = None

    def start(self) -> "AgentProcess":
        self.proc.start()
        self._child_conn.close()
        return self

    def wait_ready(self, timeout_s: float = 180.0) -> dict:
        """Block for `("ready", info)`; info carries the host_id, the
        replica endpoints + pids, and the membership credentials
        (the chaos suite replays those credentials after eviction to
        prove the fence refuses them)."""
        deadline = time.monotonic() + timeout_s
        while True:
            if self._conn.poll(0.2):
                try:
                    tag, payload = self._conn.recv()
                except (EOFError, OSError) as e:
                    raise RuntimeError(
                        f"agent child pid={self.proc.pid} died during "
                        f"boot (exitcode={self.proc.exitcode})") from e
                if tag == "error":
                    raise RuntimeError(
                        f"agent {self.spec.host_id} failed to boot: "
                        f"{payload}")
                assert tag == "ready", tag
                self.info = payload
                return payload
            if not self.proc.is_alive():
                raise RuntimeError(
                    f"agent child pid={self.proc.pid} exited during "
                    f"boot (exitcode={self.proc.exitcode})")
            if time.monotonic() > deadline:
                self.kill()
                raise TimeoutError(
                    f"agent {self.spec.host_id} not ready after "
                    f"{timeout_s}s")

    def alive(self) -> bool:
        return self.proc.is_alive()

    def exitcode(self) -> Optional[int]:
        return self.proc.exitcode

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid

    def stop(self, timeout_s: float = 10.0) -> Optional[int]:
        """Graceful teardown: ask the agent to fence its replicas and
        exit, then reap. Falls through to SIGKILL if it won't."""
        try:
            self._conn.send(("stop",))
        except (BrokenPipeError, OSError):
            pass
        return self.reap(timeout_s)

    def kill(self) -> None:
        """SIGKILL — the chaos path. The replicas die via their
        watchdog chain, not via any cleanup here."""
        if self.proc.is_alive():
            self.proc.kill()

    def reap(self, timeout_s: float = 10.0) -> Optional[int]:
        self.proc.join(timeout_s)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout_s)
        try:
            self._conn.close()
        except OSError:
            pass
        return self.proc.exitcode
