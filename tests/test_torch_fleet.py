"""The port's process fleet (`serve.fleet`) held against the JAX package's,
case by case of tests/test_fleet.py and tests/test_data_plane.py:

- supervisor mechanics in-process (the `spawn` seam swaps children for
  duck types): autoscale decisions sweep by sweep under one scripted
  load, below-floor repair, submit failover, a rolling upgrade -- the
  same decisions, counters and tokens on both packages;
- real replica PROCESSES of the port on the CPU: a SIGKILLed supervisor
  leaves no orphan (the watchdog alone), a supervisor's orphaned arena
  is reclaimed by name, and a replica SIGKILLed mid-burst
  (`FaultPlan.wrap_fleet`) ends every request in exactly one completed
  outcome with the JAX engine's tokens on the same weights;
- the child's boot contract: a CUDA replica without a card dies during
  boot and `wait_ready` raises; children never build kernels;
- `testing/traffic.py` against the original: the text, and its draws,
  arrival schedule and SLO report under one seed.

The JAX package's own replica children are not spawned: its side of a
real-process case is its in-process engine on the same weights."""

import multiprocessing
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from paddle_tpu.testing import traffic as j_traffic
from paddle_tpu_torch.serve.fleet import (EXIT_ORPHANED, ReplicaProcess,
                                          ReplicaSpec)
from paddle_tpu_torch.serve.shm_arena import ArenaError, ShmArena
from paddle_tpu_torch.testing import traffic as t_traffic
from torch_fleet import (JAX, TORCH, await_true, engine, jax_tokens,
                         mk_prompts, proc_gone, tiny_spec)

pytestmark = [pytest.mark.fleet, pytest.mark.faults]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# supervisor mechanics (spawn seam: no processes, no model)


def seam_classes(side):
    class SeamServer(side.IdleServer):
        """Idle replica with a scriptable load and a shutdown count."""

        def __init__(self):
            super().__init__()
            self.live_load = 0
            self.shutdowns = 0
            self.die = False

        def load(self):
            return self.live_load

        def shutdown(self):
            self.shutdowns += 1

        def step(self):
            if self.die:
                raise side.ReplicaDeadError("seam replica killed")
            return False

    class AcceptingSeam(SeamServer):
        _next = [0]

        def __init__(self):
            super().__init__()
            self.submitted = []

        @property
        def queue_space(self):
            return 8

        def submit(self, prompt, **kwargs):
            self._next[0] += 1
            self.submitted.append(self._next[0])
            self.live_load += 1
            return self._next[0]

    class FatalOnSubmit(AcceptingSeam):
        def submit(self, prompt, **kwargs):
            raise side.ReplicaDeadError("transport lost on submit")

    return SeamServer, AcceptingSeam, FatalOnSubmit


def seam_spec(side):
    return side.ReplicaSpec(builder="unused:unused")


#: the scripted load of the autoscale case: sweep -> load of every
#: spawned replica from that sweep on (a spike on the first, then quiet)
LOAD_SCRIPT = {0: [4], 8: [0, 0, 0]}


def test_autoscale_decisions_sweep_by_sweep_match_jax():
    def run(side):
        Seam, _, _ = seam_classes(side)
        spawned = []

        def spawn(spec):
            s = Seam()
            spawned.append(s)
            return s

        sup = side.FleetSupervisor(
            seam_spec(side), min_replicas=1, max_replicas=3,
            policy=side.AutoscalePolicy(queue_high=1.0, cooldown_sweeps=2,
                                        idle_sweeps=3),
            spawn=spawn)
        sup.start()
        trace = []
        for i in range(38):
            for s, load in zip(spawned, LOAD_SCRIPT.get(i, [])):
                s.live_load = load
            sup.sweep()
            c = sup.counters()
            trace.append((c["replicas_routable"], dict(sup.stats)))
        out = (trace, sup.router.stats["replicas_reaped"],
               [s.shutdowns for s in spawned])
        sup.shutdown(drain=False)
        return out

    ref, got = run(JAX), run(TORCH)
    assert got == ref
    trace, reaped, shutdowns = got
    assert max(n for n, _ in trace) == 3            # hit the ceiling
    assert trace[-1][0] == 1                        # back to the floor
    assert trace[-1][1]["scale_out_events"] == 2
    assert trace[-1][1]["scale_in_events"] == 2 == reaped
    assert shutdowns == [0, 1, 1]


def test_below_floor_repair_skips_cooldown():
    def run(side):
        Seam, _, _ = seam_classes(side)
        spawned = []

        def spawn(spec):
            s = Seam()
            spawned.append(s)
            return s

        sup = side.FleetSupervisor(
            seam_spec(side), min_replicas=2, max_replicas=3,
            policy=side.AutoscalePolicy(cooldown_sweeps=1000), spawn=spawn)
        sup.start()
        sup.sweep()                   # healthy tick (starts cooldown)
        spawned[0].die = True
        sup.sweep()                   # death harvested + repaired
        out = (sup.router.stats["replicas_lost"],
               sup.counters()["replicas_routable"],
               sup.stats["scale_out_events"], len(spawned))
        sup.shutdown(drain=False)
        return out

    ref, got = run(JAX), run(TORCH)
    assert got == ref == (1, 2, 1, 3)


def test_submit_fails_over_when_the_picked_replica_is_dead():
    def run(side):
        _, Accepting, Fatal = seam_classes(side)
        bad, good = Fatal(), Accepting()
        good.live_load = 1            # least-loaded pick lands on bad
        router = side.ServingRouter([bad, good])
        rr = router.submit(np.arange(3, dtype=np.int32), max_new=2)
        return (len(good.submitted), router.stats["replicas_lost"],
                rr in router.replicas[1].pending.values())

    ref, got = run(JAX), run(TORCH)
    assert got == ref == (1, 1, True)


def _warm(index):
    engine(JAX, index).serve([np.arange(5, dtype=np.int32)], max_new=2,
                             buckets=(16,))


@pytest.fixture(scope="module")
def jax_ref():
    """Compile the JAX engine the reference tokens come from outside the
    cases' own time."""
    _warm(0)


@pytest.fixture(scope="module")
def warm_jax_engines(jax_ref):
    """Compile the second JAX engine of the rolling upgrade too (a JAX
    engine compiles per instance)."""
    _warm(1)


@pytest.mark.slow
def test_rolling_upgrade_zero_sheds(warm_jax_engines):
    """Replacement first, then the old replica retires in place: no
    shed, the replacement spawned once, every request completed with
    the JAX engine's tokens. Slow, as JAX's: its JAX side compiles a
    second engine (a JAX engine compiles per instance)."""
    prompts = mk_prompts(3, seed=11)

    def run(side):
        engines = [engine(side, 0), engine(side, 1)]
        built = []

        def spawn(spec):
            srv = side.ServingServer(engines[len(built) % 2], max_queue=8,
                                     max_retries=1, buckets=(16,))
            built.append(srv)
            return srv

        sup = side.FleetSupervisor(seam_spec(side), min_replicas=1,
                                   max_replicas=2, spawn=spawn)
        sup.start()
        rids = [sup.submit(p, max_new=3) for p in prompts]
        sup.sweep()                   # work in flight on the old replica
        sup.rolling_upgrade(seam_spec(side))
        res = sup.run()
        sup.reconcile()
        c = sup.router.counters()
        out = (c["shed"], c["completed"], sup.stats["upgrades"],
               sup.stats["reaped"], len(built),
               [(res[r].outcome, [int(t) for t in res[r].tokens])
                for r in rids])
        sup.shutdown(drain=False)
        return out

    ref, got = run(JAX), run(TORCH)
    assert got == ref
    assert got[:5] == (0, 3, 1, 1, 2)
    assert got[5] == [("completed", jax_tokens(p, 3)) for p in prompts]


# ---------------------------------------------------------------------------
# real replica processes of the port (CPU)


def _orphan_run(main):
    ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe()
    sup_proc = ctx.Process(target=main, args=(child_conn,))
    sup_proc.start()
    child_conn.close()
    try:
        assert parent_conn.poll(60.0), "supervisor never reported"
        return sup_proc, parent_conn.recv()
    finally:
        parent_conn.close()


def test_supervisor_sigkill_leaves_no_orphan_children():
    """SIGKILL the SUPERVISOR -- no drain, no atexit -- and every
    replica child exits on the parent-death watchdog alone."""
    from paddle_tpu_torch.testing.fleet import orphan_fleet_main

    sup_proc, grandchildren = _orphan_run(orphan_fleet_main)
    assert len(grandchildren) == 2
    assert all(not proc_gone(pid) for pid in grandchildren)
    os.kill(sup_proc.pid, signal.SIGKILL)
    sup_proc.join(10.0)
    assert await_true(lambda: all(proc_gone(p) for p in grandchildren)), \
        f"orphaned replica processes survive: {grandchildren}"


def test_supervisor_sigkill_orphaned_arena_reclaimed():
    """The arena's creator SIGKILLed: its replicas exit on the watchdog,
    and attaching to the orphaned arena BY NAME still reclaims every
    dead-owner segment (this test owns the unlink the supervisor never
    ran)."""
    from paddle_tpu_torch.testing.fleet import orphan_data_fleet_main

    sup_proc, info = _orphan_run(orphan_data_fleet_main)
    assert info["pids"] and all(not proc_gone(p) for p in info["pids"])
    os.kill(sup_proc.pid, signal.SIGKILL)
    sup_proc.join(10.0)
    assert await_true(lambda: all(proc_gone(p) for p in info["pids"]))
    arena = ShmArena(info["arena"], create=False)
    try:
        c = arena.counters()
        assert c["arena_segments_live"] >= 1
        assert c["arena_segments_leaked"] == c["arena_segments_live"]
        assert arena.reclaim_orphans() == len(info["ticket"]["segs"])
        with pytest.raises(ArenaError, match="stale ticket"):
            arena.gather(info["ticket"])
        arena.reconcile()
    finally:
        arena.close(destroy=True)


def test_sigkill_replica_mid_burst_exactly_once(tmp_path, jax_ref):
    """Two replica processes on the shared weights, one SIGKILLed
    mid-burst by `FaultPlan.wrap_fleet`: every request ends in exactly
    one completed outcome, redistributed work keeps its retry budget,
    the fleet counters reconcile across the process boundary, the
    tokens are the JAX engine's, and the supervisor repairs the floor
    with a new process. The fault fires as it does in the JAX
    package's plan (`fired`)."""
    sup = TORCH.FleetSupervisor(tiny_spec(tmp_path), min_replicas=2,
                                max_replicas=2)
    sup.start()
    pids = [p.pid for p in sup.procs.values()]
    prompts = mk_prompts(6)
    try:
        plan = TORCH.FaultPlan(fleet_sigkill_at=2, fleet_sigkill_replica=1)
        plan.wrap_fleet(sup)
        rids = [sup.submit(p, max_new=4) for p in prompts]
        res = sup.run()
        sup.reconcile()               # the exactly-once audit
        c = sup.router.counters()
        assert plan.fired == ["fleetkill@2"]
        assert c["replicas_lost"] == 1 and c["redistributed"] >= 1
        assert sorted(res) == sorted(rids)
        assert all(res[i].outcome == "completed" for i in rids)
        assert any(res[i].redistributions > 0 for i in rids)
        assert all(r.retries == 0 for r in res.values())
        assert c["completed"] == len(rids) == c["fleet_completed"]
        assert c["fleet_shed"] == 0 and c["fleet_failed"] == 0
        assert sup.stats["spawned"] == 3
        assert sup.counters()["procs_alive"] == 2
        pids += [p.pid for p in sup.procs.values() if p is not None]
    finally:
        sup.shutdown(drain=False)
    for p, rid in zip(prompts, rids):
        assert res[rid].tokens == jax_tokens(p, 4)
    live = [p for p in set(pids) if not proc_gone(p)]
    assert not live, f"replica processes outlived shutdown: {live}"


def test_cuda_replica_without_a_card_dies_in_boot(tmp_path):
    """A replica spec for the card on a machine without one: the child
    raises while resolving its device (it never goes on on the CPU),
    and the parent's wait_ready names the death. Its kernels are not
    built either: the parent builds before spawning, and here nvcc is
    missing, so that fails first unless the build is already cached."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path is not reachable")
    spec = tiny_spec(tmp_path)
    spec = ReplicaSpec(builder=spec.builder, kwargs=spec.kwargs,
                       device="cuda")
    proc = ReplicaProcess(spec)
    proc.start = lambda: (proc.proc.start(), proc._child_conn.close(),
                          proc)[-1]       # skip the parent-side build
    proc.start()
    try:
        with pytest.raises(RuntimeError, match="during boot"):
            proc.wait_ready(60.0)
    finally:
        code = proc.reap()
    assert code == 1 and code != EXIT_ORPHANED


def test_kernel_cache_holds_under_concurrent_builds(tmp_path):
    """Several processes finding the same missing library at once (the
    parent of each fleet builds before it spawns): each compiles to a
    private temporary and renames it into place, so every process ends
    with the one library and no temporary is left. nvcc is a stand-in
    script here that writes its `-o` target after a pause."""
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text(textwrap.dedent("""\
        #!/bin/sh
        sleep 0.3
        while [ "$1" != "-o" ]; do shift; done
        printf built > "$2"
        echo "ptxas info: stand-in"
        """))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    code = textwrap.dedent(f"""\
        from pathlib import Path
        from paddle_tpu_torch.ops import _cuda
        _cuda.BUILD_DIR = Path({str(build)!r})
        _cuda.build_all(["flash_attention"])
        print(_cuda.library_path("flash_attention").read_text())
        """)
    env = {**os.environ, "CUDA_HOME": str(tmp_path / "cuda"),
           "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=60)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0]
    assert all(o.strip() == "built" for o in outs)
    assert sorted(f.name for f in build.iterdir()
                  if f.suffix == ".so") == [
        f"flash_attention-{n}" for n in sorted(
            f.name.split("-", 1)[1] for f in build.iterdir()
            if f.suffix == ".so")]
    assert not [f for f in build.iterdir() if f.suffix == ".tmp"]
    assert len([f for f in build.iterdir() if f.suffix == ".so"]) == 1


def test_build_chaos_replica_arms_its_own_arena(tmp_path):
    """`build_chaos_replica`: the config's engine behind a server that
    attached the supervisor's arena by name, its FaultPlan armed on that
    handle (the nth scatter raises), on the CPU in process."""
    from paddle_tpu_torch.testing.faults import build_chaos_replica
    from paddle_tpu_torch.testing.fleet import TINY

    config = tmp_path / "serve_config.py"
    config.write_text(textwrap.dedent(f"""\
        import numpy as np
        from paddle_tpu_torch.models import transformer as T

        def get_serve_config():
            cfg = T.TransformerConfig(**{TINY!r})
            return dict(params=T.init_params(np.random.RandomState(0), cfg,
                                             device="cpu"),
                        cfg=cfg, slots=2, max_len=32, page_size=4)
        """))
    arena = ShmArena(seg_size=2048, n_segs=8)
    try:
        srv = build_chaos_replica(
            fault_plan=dict(arena_error_at=0), config=str(config),
            role="prefill", buckets=[16], data_plane=arena.name,
            device="cpu")
        assert srv.role == "prefill" and srv.data_plane is not None
        assert srv.data_plane.name == arena.name
        with pytest.raises(ArenaError, match="injected"):
            srv.data_plane.scatter([b"x" * 16])
        srv.data_plane.scatter([b"x" * 16])     # fired once
    finally:
        arena.close(destroy=True)


# ---------------------------------------------------------------------------
# testing/traffic.py


def test_traffic_module_is_the_original():
    with open(os.path.join(REPO, "paddle_tpu", "testing",
                           "traffic.py")) as a, \
            open(os.path.join(REPO, "paddle_tpu_torch", "testing",
                              "traffic.py")) as b:
        assert a.read() == b.read()


class VirtualTime:
    """`time` for the traffic module under test: sleep advances a
    virtual clock, monotonic reads it."""

    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.now += max(float(s), 0.0)


def test_traffic_draws_schedule_and_report_match_the_original(monkeypatch):
    """One seeded script through both modules: TrafficShape's prompts
    and lengths, the open-loop arrival schedule (virtual time; each
    arrival recorded by a stand-in client) and the SLO report over the
    same results."""
    def script(tr):
        shape = tr.TrafficShape(vocab=61, n_families=5, out_base=6,
                                out_cap=20, seed=3)
        rng = np.random.RandomState(7)
        draws = [shape.sample(rng) for _ in range(40)]
        clock = VirtualTime()
        arrivals = []

        def client(addr, prompt, max_new, **kw):
            arrivals.append((round(clock.now - 100.0, 9),
                             [int(t) for t in prompt], int(max_new)))
            i = len(arrivals)
            if i % 5 == 0:
                return tr.StreamResult(status=429, retry_after="1")
            return tr.StreamResult(
                status=200, outcome="completed",
                tokens=list(range(i % 4 + 1)), ttft_s=0.01 * i,
                gaps_s=[0.002 * (i % 3 + 1)] * 3)

        monkeypatch.setattr(tr, "time", clock)
        monkeypatch.setattr(tr, "stream_generate", client)
        results = tr.open_loop(("127.0.0.1", 1), shape,
                               phases=((20.0, 10), (80.0, 15)), seed=4)
        arrivals.sort()
        rep = tr.slo_report(results, 2.5)
        return ([(p.tolist(), n) for p, n in draws], arrivals,
                [(r.status, r.outcome) for r in results], rep)

    got, ref = script(t_traffic), script(j_traffic)
    assert got == ref
    assert len(got[1]) == 25 and got[3]["shed_429"] == 5
