"""Multi-host job launcher (port of `paddle_tpu.parallel.launch`).

Three modes, as in the JAX package:

1. ssh fan-out (`launch_ssh`): start the SAME `python -m
   paddle_tpu_torch` command on every host with the job's rendezvous
   wired (process 0's host:port is the coordinator, passed as
   `--coordinator/--num-processes/--process-id`). Logs stream back with
   a host prefix; the first failure tears the job down.

2. JobSet manifest (`emit_jobset`): a Kubernetes JobSet YAML for a
   gang-scheduled multi-host job, the JAX package's template (its
   command naming this package).

3. Elastic local gang (`GangSupervisor`): spawn N trainer PROCESSES on
   this host, each joining one `torch.distributed` group (gloo, or NCCL
   where every member has a card of its own; members sharing one card
   run gloo on its CUDA tensors) and running the ZeRO-sharded resilient
   loop (`run_gang_worker`). The supervisor watches exits and per-rank
   heartbeat files; a member that dies (SIGKILL, OOM, watchdog exit 75)
   or wedges (alive but no heartbeat) tears the whole barrier down and
   the gang REFORMS at the surviving count -- the reshard-on-restore
   checkpoint path (`train.checkpoint.ElasticCheckpointManager`) makes
   the N-1 gang resume from the N gang's last durable step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.cluster.lease import LeaseTable


def _stream(proc: subprocess.Popen, prefix: str) -> None:
    for line in proc.stdout:  # type: ignore[union-attr]
        sys.stdout.write(f"[{prefix}] {line if isinstance(line, str) else line.decode()}")
        sys.stdout.flush()


def launch_ssh(hosts: Sequence[str], command: Sequence[str], *,
               coordinator_port: int = 1234,
               workdir: Optional[str] = None,
               python: str = "python",
               extra_env: Optional[Dict[str, str]] = None,
               ssh_opts: Sequence[str] = ("-o", "BatchMode=yes"),
               dry_run: bool = False) -> int:
    """Fan a paddle_tpu_torch command out to N hosts over ssh.

    hosts: ssh destinations; hosts[0] is the coordinator.
    command: argv AFTER `python -m paddle_tpu_torch`, e.g.
        ["train", "--config", "cfg.py", "--batch-size", "512"].
    Every process gets --coordinator/--num-processes/--process-id
    appended (wired to parallel.distributed.initialize by the CLI).

    Returns the first nonzero exit code (0 if all succeed). On any
    failure the remaining processes are terminated — the gang-scheduling
    semantic (a dead trainer must kill the barrier, unlike the
    reference's v1 where it simply hung; SURVEY §5).
    """
    coord = f"{hosts[0].split('@')[-1]}:{coordinator_port}"
    env = dict(extra_env or {})
    procs: List[subprocess.Popen] = []
    threads: List[threading.Thread] = []
    cmds: List[List[str]] = []
    for i, host in enumerate(hosts):
        argv = [python, "-m", "paddle_tpu_torch", *command,
                "--coordinator", coord,
                "--num-processes", str(len(hosts)),
                "--process-id", str(i)]
        remote = ""
        if workdir:
            remote += f"cd {shlex.quote(workdir)} && "
        remote += " ".join(
            [f"{k}={shlex.quote(v)}" for k, v in env.items()]
            + [shlex.quote(a) for a in argv])
        cmds.append(["ssh", *ssh_opts, host, remote])

    if dry_run:
        for c in cmds:
            print(" ".join(shlex.quote(x) for x in c))
        return 0

    for host, c in zip(hosts, cmds):
        p = subprocess.Popen(c, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        t = threading.Thread(target=_stream, args=(p, host), daemon=True)
        t.start()
        procs.append(p)
        threads.append(t)

    rc = 0
    try:
        # wait for the first failure (or all successes)
        pending = set(range(len(procs)))
        while pending and rc == 0:
            for i in list(pending):
                code = procs[i].poll()
                if code is None:
                    continue
                pending.discard(i)
                if code != 0:
                    rc = code
            if pending and rc == 0:
                time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        for t in threads:
            t.join(timeout=5)
    return rc


def emit_jobset(name: str, *, image: str, command: Sequence[str],
                num_hosts: int, tpu_topology: str = "4x4",
                accelerator: str = "tpu-v5-lite-podslice",
                chips_per_host: int = 4,
                namespace: str = "default") -> str:
    """Render the JAX package's JobSet YAML manifest for a gang-scheduled
    job (its text for the same arguments, the container command naming
    this package).

    command: argv after `python -m paddle_tpu_torch` run in every pod."""
    cmd_json = ", ".join(
        f'"{c}"' for c in ["python", "-m", "paddle_tpu_torch", *command])
    return f"""apiVersion: jobset.x-k8s.io/v1alpha2
kind: JobSet
metadata:
  name: {name}
  namespace: {namespace}
spec:
  failurePolicy:
    maxRestarts: 3
  replicatedJobs:
  - name: workers
    template:
      spec:
        parallelism: {num_hosts}
        completions: {num_hosts}
        backoffLimit: 0
        template:
          spec:
            restartPolicy: Never
            nodeSelector:
              cloud.google.com/gke-tpu-accelerator: {accelerator}
              cloud.google.com/gke-tpu-topology: {tpu_topology}
            containers:
            - name: trainer
              image: {image}
              command: [{cmd_json}]
              resources:
                limits:
                  google.com/tpu: {chips_per_host}
"""


# ---------------------------------------------------------------------------
# elastic local gang: spec + worker + supervisor
# ---------------------------------------------------------------------------

#: repo root, for the children's PYTHONPATH and cwd
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


class GangFailedError(RuntimeError):
    """The gang cannot make progress: membership fell below
    `min_procs`, or the overall deadline expired. The last durable
    checkpoint is intact — a rerun with a fresh supervisor resumes."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _atomic_json(path: pathlib.Path, payload: dict) -> None:
    """tmp + rename so a reader (the supervisor polling heartbeats, a
    worker killed mid-write) never sees a torn file."""
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(payload))
    os.replace(tmp, path)


def _read_json(path: pathlib.Path) -> Optional[dict]:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return None


@dataclasses.dataclass
class GangSpec:
    """Everything a gang CHILD needs, JSON-serialized across the spawn
    boundary (the `serve.fleet.ReplicaSpec` idiom): the job itself is a
    `"module:function"` builder string the child imports and calls —
    no pickled closures cross the process boundary.

    The builder must return a dict with keys `model`, `loss_fn`,
    `optimizer`, `input_specs` (tuple of ShapeSpec for model.init) and
    `batches` (callable `total_steps -> iterable of (x, y)` GLOBAL
    numpy batches, deterministic — every rank derives its own slice,
    and a reformed gang replays the identical stream).
    """

    builder: str
    builder_kwargs: Dict[str, Any]
    checkpoint_dir: str
    workdir: str                  # heartbeats + per-rank result files
    total_steps: int
    checkpoint_every: int = 2
    seed: int = 0
    coordinator: Optional[str] = None
    num_processes: int = 1
    gang_epoch: int = 0
    watchdog_timeout_s: Optional[float] = None
    device: Optional[str] = None      # None -> cuda; "cpu"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "GangSpec":
        return cls(**json.loads(text))


def gang_child_main() -> None:
    """Entry point for a spawned gang member (env-driven:
    PADDLE_TPU_GANG_SPEC = spec JSON path, PADDLE_TPU_GANG_RANK). It
    joins the gang's process group before anything else."""
    spec = GangSpec.from_json(
        pathlib.Path(os.environ["PADDLE_TPU_GANG_SPEC"]).read_text())
    rank = int(os.environ["PADDLE_TPU_GANG_RANK"])
    from paddle_tpu_torch.parallel import distributed as D

    if spec.num_processes > 1:
        D.initialize(coordinator_address=spec.coordinator,
                     num_processes=spec.num_processes, process_id=rank,
                     device=spec.device,
                     backend=gang_backend(spec.device, spec.num_processes))
    run_gang_worker(spec, rank)


def gang_backend(device, members: int) -> str:
    """The gang's process-group backend: gloo on the CPU; on the card
    NCCL where every member has a card of its own, else gloo on the
    shared card's CUDA tensors (NCCL refuses two ranks on one device)."""
    import torch

    from paddle_tpu_torch.core.devices import resolve_device

    if resolve_device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= members else "gloo"


def run_gang_worker(spec: GangSpec, rank: int) -> dict:
    """One gang member's whole life: build the job from the spec's
    builder string, land the state in the ZeRO layout for the gang's
    data mesh, and drive the resilient loop -- restore (resharding if
    the checkpoint came from another gang size), train, heartbeat after
    every step, checkpoint on cadence. Writes a per-rank result JSON
    (files, not stdout: a SIGKILLed sibling must not truncate the
    survivor's report)."""
    import importlib

    import torch

    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.parallel import distributed as D
    from paddle_tpu_torch.parallel.train_step import make_zero_train_step
    from paddle_tpu_torch.train import events as E
    from paddle_tpu_torch.train.checkpoint import ElasticCheckpointManager
    from paddle_tpu_torch.train.resilience import Preempted, ResilientTrainer
    from paddle_tpu_torch.train.state import TrainState
    from paddle_tpu_torch.train.trainer import Trainer

    mesh = mesh_lib.build_mesh(
        mesh_lib.MeshConfig(data=D.process_count()), spec.device)

    mod_name, _, fn_name = spec.builder.partition(":")
    job = getattr(importlib.import_module(mod_name),
                  fn_name)(**spec.builder_kwargs)
    model, loss_fn = job["model"], job["loss_fn"]
    optimizer = job["optimizer"]

    trainer = Trainer(model, loss_fn, optimizer, seed=spec.seed,
                      device=mesh.device)
    # Trainer.init_state's draw, landed in the ZeRO layout: every rank
    # (and every gang size) inits identical params
    init = trainer.init_state(*job["input_specs"])
    state = TrainState.create_zero(init.params, init.model_state,
                                   optimizer, mesh)

    manager = ElasticCheckpointManager(spec.checkpoint_dir, mesh=mesh)
    rt = ResilientTrainer(
        trainer, spec.checkpoint_dir,
        checkpoint_manager=manager,
        checkpoint_every_n_batches=spec.checkpoint_every,
        watchdog_timeout_s=spec.watchdog_timeout_s,
        step_builder=lambda opt: make_zero_train_step(
            model, loss_fn, opt, mesh, donate=False),
        gang_epoch=spec.gang_epoch)

    def factory():
        # the GLOBAL batch on every rank: the ZeRO step keeps its rows
        for x, y in job["batches"](spec.total_steps):
            yield (torch.as_tensor(x, device=mesh.device),
                   torch.as_tensor(y, device=mesh.device))

    workdir = pathlib.Path(spec.workdir)
    hb_path = workdir / f"hb_{spec.gang_epoch}_{rank}.json"
    steps: List[int] = []
    losses: List[float] = []

    def handler(ev):
        if isinstance(ev, E.EndIteration):
            steps.append(ev.batch_id)
            losses.append(ev.cost)
            _atomic_json(hb_path, {"step": ev.batch_id,
                                   "t": time.time(),
                                   "pid": os.getpid()})

    preempted = False
    try:
        final = rt.run(state, factory, num_passes=1,
                       event_handler=handler)
        final_step = int(final.step)
    except Preempted as p:
        # teardown's SIGTERM landed at a step boundary: the drain save
        # is durable, the member exits clean and rejoins next epoch
        preempted = True
        final_step = p.step
    result = {
        "rank": rank,
        "gang_epoch": spec.gang_epoch,
        "restored_step": rt.restored_step,
        "final_step": final_step,
        "preempted": preempted,
        "steps": steps,
        "losses": losses,
        "counters": {k: float(v) for k, v in rt.counters().items()},
    }
    _atomic_json(workdir / f"result_{spec.gang_epoch}_{rank}.json",
                 result)
    return result


class GangSupervisor:
    """Elastic gang-of-processes trainer supervisor.

    Spawns `num_processes` gang members (each a fresh python process
    running `gang_child_main`), then watches two signals per member:
    its EXIT CODE and its heartbeat file (written after every step).
    Failure handling, in classification order:

    - **crashed** (exit not in {0, 75}): the member's host is gone —
      SIGKILL, OOM, segfault. The whole barrier is torn down (a gloo
      collective with a dead peer never completes; surviving members
      are blocked inside it, so SIGTERM → grace → SIGKILL) and the
      gang reforms at `previous - crashed` members.
    - **watchdog exit (75)**: the member's own progress deadline fired
      (train.resilience.Watchdog) — it is a HEALTHY host that detected
      a wedge. The still-alive members that stopped heartbeating are
      the wedged ones: they get fenced with a real SIGKILL
      (`fenced_wedged`), and only THEY count as lost.
    - **stale heartbeat, nobody dead**: a member is alive but not
      scheduling (SIGSTOP, pathological swap). A dead-or-wedged peer
      stalls everyone's heartbeats (they block in the next collective),
      so the victim is picked by direct evidence first — a process in
      the stopped state — falling back to the oldest heartbeat. The
      victim is fenced (SIGKILL), then the usual teardown/reform runs.

    Attribution policy: members lost = the ranks observed failed at the
    FIRST failing poll (fault injection waits on the victim's corpse,
    making this deterministic); later collateral exits during teardown
    are NOT lost members — their hosts rejoin the reformed gang.

    Every reform bumps `gang_epoch` (tagged on step spans and worker
    counters), picks a fresh coordinator port, renumbers ranks 0..M-1,
    and resumes from the newest durable checkpoint via the
    reshard-on-restore path. Below `min_procs`: `GangFailedError`.
    """

    def __init__(self, builder: str,
                 builder_kwargs: Optional[Dict[str, Any]] = None, *,
                 workdir: str, checkpoint_dir: str,
                 num_processes: int, total_steps: int,
                 checkpoint_every: int = 2, seed: int = 0,
                 min_procs: int = 1,
                 watchdog_timeout_s: Optional[float] = None,
                 heartbeat_timeout_s: float = 60.0,
                 boot_timeout_s: float = 300.0,
                 grace_s: float = 5.0, poll_s: float = 0.25,
                 device: Optional[str] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 flight: Optional[Any] = None,
                 membership: Optional[Any] = None,
                 host_prefix: str = "gang"):
        if num_processes < 1 or min_procs < 1:
            raise ValueError("num_processes and min_procs must be >= 1")
        self.builder = builder
        self.builder_kwargs = dict(builder_kwargs or {})
        self.workdir = pathlib.Path(workdir)
        self.checkpoint_dir = checkpoint_dir
        self.num_processes = num_processes
        self.total_steps = total_steps
        self.checkpoint_every = checkpoint_every
        self.seed = seed
        self.min_procs = min_procs
        self.watchdog_timeout_s = watchdog_timeout_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.boot_timeout_s = boot_timeout_s
        self.grace_s = grace_s
        self.poll_s = poll_s
        self.device = device
        self.extra_env = dict(extra_env or {})
        self.flight = flight
        # optional membership mirror (MembershipService or -Client
        # duck type): each rank is a fake host `{prefix}-{rank}`; its
        # lease renews on observed heartbeats, and an EVICTION seen in
        # the view is a lost member — the teardown/reform path fires
        # from a view change, not only from a local waitpid
        self.membership = membership
        self.host_prefix = host_prefix
        self._member_creds: Dict[int, Tuple[int, int]] = {}
        self.membership_evictions = 0
        # ledger (registry-source shaped: numeric values only)
        self.gang_epoch = 0
        self.reforms = 0
        self.members_lost = 0
        self.fenced_wedged = 0
        self.watchdog_exits = 0
        self.spawned = 0
        # live gang. Staleness is lease-based (the shared
        # cluster.lease semantics): every member holds a lease that
        # starts on the boot budget and re-arms with the heartbeat
        # ttl each time the supervisor OBSERVES a fresh heartbeat
        # write — expiry is the one staleness verdict
        self.procs: Dict[int, subprocess.Popen] = {}
        self._hb_leases = LeaseTable(default_ttl_s=boot_timeout_s,
                                     clock=time.monotonic)
        self._hb_seen: Dict[int, Tuple] = {}
        self._logs: List[Any] = []

    # -- observability -----------------------------------------------------

    def counters(self) -> dict:
        return {
            "gang_epoch": self.gang_epoch,
            "reforms": self.reforms,
            "members_lost": self.members_lost,
            "fenced_wedged": self.fenced_wedged,
            "watchdog_exits": self.watchdog_exits,
            "spawned": self.spawned,
            "membership_evictions": self.membership_evictions,
            "active": sum(1 for p in self.procs.values()
                          if p.poll() is None),
        }

    def bind_metrics(self, registry, *, prefix: str = "train_gang",
                     labels: Optional[dict] = None) -> None:
        registry.register_source(prefix, self.counters, labels=labels)

    def member_heartbeat(self, rank: int) -> Optional[dict]:
        return _read_json(
            self.workdir / f"hb_{self.gang_epoch}_{rank}.json")

    # -- spawn / teardown --------------------------------------------------

    def _spawn(self, count: int) -> None:
        self.workdir.mkdir(parents=True, exist_ok=True)
        spec = GangSpec(
            builder=self.builder, builder_kwargs=self.builder_kwargs,
            checkpoint_dir=self.checkpoint_dir,
            workdir=str(self.workdir), total_steps=self.total_steps,
            checkpoint_every=self.checkpoint_every, seed=self.seed,
            coordinator=f"127.0.0.1:{_free_port()}",
            num_processes=count, gang_epoch=self.gang_epoch,
            watchdog_timeout_s=self.watchdog_timeout_s,
            device=self.device)
        spec_path = self.workdir / f"spec_{self.gang_epoch}.json"
        spec_path.write_text(spec.to_json())
        code = ("from paddle_tpu_torch.parallel.launch import "
                "gang_child_main; gang_child_main()")
        env = dict(os.environ)
        env["PYTHONPATH"] = (str(_REPO_ROOT) + os.pathsep
                             + env.get("PYTHONPATH", ""))
        env.update(self.extra_env)
        env["PADDLE_TPU_GANG_SPEC"] = str(spec_path)
        for rank in range(count):
            log_f = open(self.workdir
                         / f"log_{self.gang_epoch}_{rank}.txt", "w")
            self._logs.append(log_f)
            p = subprocess.Popen(
                [sys.executable, "-c", code],
                cwd=_REPO_ROOT,
                env={**env, "PADDLE_TPU_GANG_RANK": str(rank)},
                stdout=log_f, stderr=subprocess.STDOUT)
            self.procs[rank] = p
            self._hb_leases.grant(rank)     # the boot budget
            self.spawned += 1
        self._membership_register(count, spec.coordinator)

    def _teardown(self, reason: str) -> None:
        """SIGTERM (a member at a step boundary drains one save and
        exits clean) → grace → SIGKILL (members blocked in a dead
        collective never reach a boundary)."""
        if self.flight is not None and reason != "done":
            self.flight.record("fault", "gang-teardown",
                               reason=reason,
                               gang_epoch=self.gang_epoch)
        for p in self.procs.values():
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + self.grace_s
        for p in self.procs.values():
            left = deadline - time.monotonic()
            try:
                p.wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for f in self._logs:
            try:
                f.close()
            except OSError:
                pass
        self._logs.clear()
        self.procs.clear()
        self._hb_leases.clear()
        self._hb_seen.clear()
        self._membership_deregister()
        if self.flight is not None and reason != "done":
            self.flight.dump(str(self.workdir),
                             f"gang-teardown-{reason}",
                             extra={"counters": self.counters()})

    # -- failure detection -------------------------------------------------

    def _tick(self) -> None:
        """Per-poll hook; the fault-injection seam
        (`testing.faults.FaultPlan.wrap_gang` wraps it to deliver a
        real SIGKILL/SIGSTOP at an exact heartbeat step)."""

    @staticmethod
    def _proc_stopped(pid: int) -> bool:
        """Direct evidence of a SIGSTOPped/not-scheduling member
        (linux /proc state 'T'); False where /proc is unavailable —
        the oldest-heartbeat fallback picks the victim there."""
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().split(")")[-1].split()[0] in ("T", "t")
        except OSError:
            return False

    def _observe_heartbeats(self, ranks: List[int]) -> None:
        """Fold freshly WRITTEN heartbeats into lease renewals: a new
        (step, t) value proves the member progressed since the last
        poll, so its lease re-arms with the steady-state heartbeat
        ttl (the first heartbeat moves it off the boot budget). A
        fresh heartbeat is ground truth — if the lease lapsed only
        because the SUPERVISOR stalled past the ttl, it re-grants
        rather than declaring a progressing member stale."""
        for r in ranks:
            hb = self.member_heartbeat(r)
            booting = r not in self._hb_seen
            fresh = False
            if hb is not None:
                key = (hb.get("step"), hb.get("t"))
                if self._hb_seen.get(r) != key:
                    self._hb_seen[r] = key
                    fresh = True
                    if not self._hb_leases.renew(
                            r, ttl_s=self.heartbeat_timeout_s):
                        self._hb_leases.grant(
                            r, self.heartbeat_timeout_s)
            if fresh or (booting and hb is None):
                # membership mirrors liveness: progress renews, and a
                # still-booting member is alive by definition (its
                # boot budget is the local lease's concern)
                self._membership_renew(r)

    def _stale(self, rank: int) -> bool:
        return not self._hb_leases.alive(rank)

    # -- membership mirror (optional) --------------------------------------

    def _member_host(self, rank: int) -> str:
        return f"{self.host_prefix}-{rank}"

    def _membership_register(self, count: int,
                             coordinator: str) -> None:
        if self.membership is None:
            return
        for rank in range(count):
            try:
                r = self.membership.register(
                    self._member_host(rank),
                    {"rank": rank, "gang_epoch": self.gang_epoch,
                     "coordinator": coordinator},
                    ttl_s=self.heartbeat_timeout_s)
            except (OSError, ConnectionError, RuntimeError):
                return          # membership down: local paths still run
            self._member_creds[rank] = (r["token"], r["epoch"])

    def _membership_renew(self, rank: int) -> None:
        creds = self._member_creds.get(rank)
        if self.membership is None or creds is None:
            return
        token, epoch = creds
        try:
            resp = self.membership.renew(self._member_host(rank),
                                         token, epoch)
        except (OSError, ConnectionError, RuntimeError):
            return
        if resp["status"] == "ok":
            self._member_creds[rank] = (token, resp["epoch"])

    def _membership_lost(self, alive: List[int]) -> List[int]:
        """Ranks whose fake host has LEFT the membership view (lease
        expiry or external eviction) — host death arriving as a view
        change, the multi-host analog of a waitpid."""
        if self.membership is None:
            return []
        try:
            self.membership.tick()
            view = self.membership.view()
        except (OSError, ConnectionError, RuntimeError):
            return []
        return [r for r in alive
                if r in self._member_creds
                and self._member_host(r) not in view.hosts]

    def _membership_deregister(self) -> None:
        if self.membership is None:
            return
        for rank, (token, epoch) in list(self._member_creds.items()):
            try:
                self.membership.deregister(self._member_host(rank),
                                           token, epoch)
            except (OSError, ConnectionError, RuntimeError):
                pass            # eviction will reap it eventually
        self._member_creds.clear()

    def _fence(self, ranks: List[int]) -> None:
        for r in ranks:
            p = self.procs.get(r)
            if p is not None and p.poll() is None:
                try:
                    os.kill(p.pid, signal.SIGKILL)
                    p.wait(timeout=10)
                except OSError:
                    pass
            self.fenced_wedged += 1

    def _pick_wedged(self, alive: List[int]) -> List[int]:
        stopped = [r for r in alive
                   if self._proc_stopped(self.procs[r].pid)]
        if stopped:
            return stopped
        # oldest heartbeat: the victim stopped progressing FIRST; its
        # peers wrote at least one later heartbeat before blocking
        def hb_time(r):
            hb = self.member_heartbeat(r)
            return hb.get("t", 0.0) if hb else 0.0
        return [min(alive, key=hb_time)] if alive else []

    def _monitor(self, deadline_s: float) -> Tuple[str, List[int]]:
        """Poll until the gang finishes ("done") or loses members
        ("lost", ranks). Raises GangFailedError on the deadline."""
        t0 = time.monotonic()
        while True:
            if time.monotonic() - t0 > deadline_s:
                raise GangFailedError(
                    f"gang epoch {self.gang_epoch} made no outcome "
                    f"within {deadline_s:.0f}s")
            self._tick()
            codes = {r: p.poll() for r, p in self.procs.items()}
            alive = [r for r, c in codes.items() if c is None]
            self._observe_heartbeats(alive)
            crashed = [r for r, c in codes.items()
                       if c not in (None, 0, 75)]
            wd = [r for r, c in codes.items() if c == 75]
            if crashed:
                return "lost", crashed
            if wd:
                self.watchdog_exits += len(wd)
                victims = self._pick_wedged(
                    [r for r in alive if self._stale(r)] or alive)
                self._fence(victims)
                return "lost", victims
            if not alive:
                return "done", []
            stale = [r for r in alive if self._stale(r)]
            if stale:
                victims = self._pick_wedged(stale)
                self._fence(victims)
                return "lost", victims
            evicted = self._membership_lost(alive)
            if evicted:
                # the view says these hosts are GONE: fence locally
                # and reform at the surviving count, exactly like a
                # local staleness verdict
                self.membership_evictions += len(evicted)
                self._fence(evicted)
                return "lost", evicted
            time.sleep(self.poll_s)

    # -- drive -------------------------------------------------------------

    def run(self, *, deadline_s: float = 600.0) -> dict:
        """Drive the job to completion through any number of reforms.
        Returns {"results": [per-rank result dicts of the FINAL
        epoch], "counters": ...}."""
        t0 = time.monotonic()
        count = self.num_processes
        while True:
            self._spawn(count)
            try:
                outcome, lost = self._monitor(
                    deadline_s - (time.monotonic() - t0))
            except BaseException:
                self._teardown("error")
                raise
            if outcome == "done":
                epoch = self.gang_epoch
                self._teardown("done")
                results = []
                for rank in range(count):
                    rec = _read_json(
                        self.workdir / f"result_{epoch}_{rank}.json")
                    if rec is not None:
                        results.append(rec)
                return {"results": results,
                        "counters": self.counters()}
            self._teardown(f"lost-{sorted(lost)}")
            self.members_lost += len(lost)
            count -= len(lost)
            if count < self.min_procs:
                raise GangFailedError(
                    f"{len(lost)} member(s) lost at epoch "
                    f"{self.gang_epoch}; {count} survivors is below "
                    f"min_procs={self.min_procs}")
            self.reforms += 1
            self.gang_epoch += 1
