"""The port's per-host agent (`cluster.agent`) and the supervisor's
membership mode held against the JAX package's, case by case of
tests/test_cluster.py:

- the membership-resolved roster in-process (no processes): a host
  joining is a replica add on the next sweep, a lease expiry the
  router's crash path -- the same counters on both packages;
- a real agent process of the port (an idle replica child) registers,
  renews and fences on eviction, exiting EXIT_EVICTED with its replica
  SIGKILLed, as the JAX agent does;
- a SIGKILLed supervisor takes its whole agent tree down (agents, then
  their replica grandchildren) on the watchdog chain alone;
- the multi-host chaos case (slow, as the JAX suite's): three agents
  serving a burst, one SIGKILLed (`FaultPlan.wrap_cluster`), the fleet
  reforms at two hosts from the view change with exactly-once outcomes
  and the JAX engine's tokens.

The agent never imports torch: only its replica children do."""

import multiprocessing
import os
import signal
import subprocess
import sys

import pytest

from paddle_tpu.cluster.membership import \
    MembershipService as JMembershipService
from paddle_tpu_torch.cluster.agent import (EXIT_EVICTED, AgentProcess,
                                            AgentSpec)
from paddle_tpu_torch.cluster.membership import (MembershipClient,
                                                 MembershipServer,
                                                 MembershipService)
from paddle_tpu_torch.testing.fleet import idle_spec
from torch_fleet import (JAX, TORCH, await_true, jax_tokens, mk_prompts,
                         proc_gone, tiny_spec)

pytestmark = [pytest.mark.cluster, pytest.mark.faults]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEMBERSHIP = {"jax": JMembershipService, "torch": MembershipService}


def test_fleet_supervisor_resolves_roster_from_membership_view():
    """Membership mode, no processes: the roster comes from the view; a
    host joining is a replica add on the next sweep, a lease expiry is
    `declare_dead` before any socket error could fire; local autoscaling
    is refused (capacity is agent-owned)."""
    def run(side):
        clock = side.ManualClock()
        svc = MEMBERSHIP[side.name](default_ttl_s=10.0, clock=clock)
        reg_a = svc.register("host-a",
                             {"replicas": [["127.0.0.1", 1111]]})
        svc.register("host-b", {"replicas": [["127.0.0.1", 2222]]})
        sup = side.FleetSupervisor(
            side.ReplicaSpec(builder="unused:unused"), min_replicas=1,
            max_replicas=4, membership=svc, clock=clock)
        sup._wrap_addr = lambda addr: side.IdleServer()  # no sockets
        sup.start()
        out = [len(sup.router.replicas), sup.counters()["hosts_live"],
               sup.counters()["membership_epoch"]]
        for fn in (sup.scale_out, sup.scale_in):
            with pytest.raises(RuntimeError, match="agent-owned"):
                fn()
        reg_c = svc.register("host-c",
                             {"replicas": [["127.0.0.1", 3333]]})
        sup.sweep()
        out += [sup.stats["replicas_joined"], len(sup.router.replicas),
                sup.procs[2]]
        # host-b goes silent; a and c keep renewing across the jump
        clock.advance(6.0)
        svc.renew("host-a", reg_a["token"], svc.epoch)
        svc.renew("host-c", reg_c["token"], svc.epoch)
        clock.advance(5.0)
        sup.sweep()
        out += [dict(sup.stats), sup.router.counters()["replicas_lost"],
                sup.counters()["hosts_live"],
                sup.counters()["replicas_routable"]]
        empty = MEMBERSHIP[side.name](default_ttl_s=10.0, clock=clock)
        with pytest.raises(RuntimeError, match="no replica endpoints"):
            side.FleetSupervisor(side.ReplicaSpec(builder="unused:unused"),
                                 membership=empty).start()
        return out

    ref, got = run(JAX), run(TORCH)
    assert got == ref
    assert got[:6] == [2, 2, 2, 1, 3, None]
    assert got[6]["hosts_lost"] == 1 and got[6]["view_changes"] == 2
    assert got[7:] == [1, 2, 2]


def test_agent_never_imports_torch():
    """The agent process spawns and fences; only its replica children
    load torch (and open a CUDA context on the card)."""
    code = ("import sys; import paddle_tpu_torch.cluster.agent, "
            "paddle_tpu_torch.testing.fleet as F; F.idle_spec(); "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": REPO},
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_agent_registers_renews_and_fences_on_eviction():
    """A real agent (one idle replica) against a real-clock membership
    server: it registers its inventory, its renew loop keeps the lease
    margin positive, and when a SECOND incarnation of its host registers
    the next renew is refused and the agent tears down fenced: replica
    SIGKILLed, exit code EXIT_EVICTED."""
    svc = MembershipService(default_ttl_s=30.0)
    server = MembershipServer(svc).start()
    agent = AgentProcess(AgentSpec(
        host_id="host-0", replica_spec=idle_spec(),
        membership_addr=server.addr, ttl_s=2.0, renew_interval_s=0.05))
    try:
        info = agent.start().wait_ready(60.0)
        assert info["host_id"] == "host-0" and info["token"] is not None
        assert len(info["replicas"]) == 1 and len(info["pids"]) == 1
        assert svc.view().hosts["host-0"]["replicas"] == info["replicas"]
        assert await_true(lambda: svc.counters()["renews"] >= 2, 10.0)
        assert svc.lease_margins()["host-0"] > 0
        svc.register("host-0", {"replicas": []})   # a new incarnation
        agent.proc.join(15.0)
        assert agent.exitcode() == EXIT_EVICTED
        assert await_true(lambda: all(proc_gone(p) for p in info["pids"]))
    finally:
        agent.reap()
        server.shutdown()


def test_supervisor_sigkill_takes_down_the_whole_agent_tree():
    """SIGKILL the SUPERVISOR -- no drain, no atexit -- and the agents
    exit on their pipe EOF, then the replica GRANDCHILDREN on theirs.
    Three levels deep, zero survivors."""
    from paddle_tpu_torch.testing.fleet import orphan_cluster_main

    ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe()
    sup_proc = ctx.Process(target=orphan_cluster_main, args=(child_conn,))
    sup_proc.start()
    child_conn.close()
    try:
        assert parent_conn.poll(60.0), "supervisor never reported pids"
        pids = parent_conn.recv()
    finally:
        parent_conn.close()
    assert len(pids) == 4                   # 2 agents + 2 grandchildren
    assert all(not proc_gone(pid) for pid in pids)
    os.kill(sup_proc.pid, signal.SIGKILL)
    sup_proc.join(10.0)
    assert await_true(lambda: all(proc_gone(p) for p in pids)), \
        f"agent-tree processes survive their supervisor: {pids}"


@pytest.mark.heavyweight
@pytest.mark.slow
def test_agent_sigkill_mid_burst_reforms_at_two_hosts(tmp_path):
    """Three agents with distinct host ids, each owning one replica of
    the shared weights, the roster resolved through membership. One
    agent is SIGKILLed mid-burst; its lease expires on the injectable
    clock, the epoch bumps once, the fleet reforms at two hosts from the
    view change -- exactly-once outcomes, the JAX engine's tokens, zero
    orphans, and the dead host's credentials refused as stale."""
    rspec = tiny_spec(tmp_path)
    clock = TORCH.ManualClock()
    svc = MembershipService(default_ttl_s=30.0, clock=clock)
    server = MembershipServer(svc).start()
    agents, infos, sup = {}, {}, None
    prompts = mk_prompts(9)
    try:
        for i in range(3):
            host = f"host-{i}"
            agents[host] = AgentProcess(AgentSpec(
                host_id=host, replica_spec=rspec,
                membership_addr=server.addr, ttl_s=5.0,
                renew_interval_s=0.05)).start()
        infos = {h: a.wait_ready(180.0) for h, a in agents.items()}
        assert svc.epoch == 3 and len(svc.view().hosts) == 3
        sup = TORCH.FleetSupervisor(
            rspec, min_replicas=1, max_replicas=3,
            membership=MembershipClient(server.addr))
        sup.start()
        assert len(sup.router.replicas) == 3
        plan = TORCH.FaultPlan(cluster_sigkill_at=6,
                               cluster_sigkill_host="host-1")
        plan.wrap_cluster(sup, agents, clock=clock, service=svc)
        rids = [sup.submit(p, max_new=4) for p in prompts]
        res = sup.run()
        sup.reconcile()
        assert plan.count("agentkill") == 1
        c = sup.router.counters()
        assert c["replicas_lost"] == 1 and c["redistributed"] >= 1
        assert sorted(res) == sorted(rids)
        assert all(res[i].outcome == "completed" for i in rids)
        assert all(r.retries == 0 for r in res.values())
        assert c["completed"] == len(rids) == c["fleet_completed"]
        assert sup.counters()["hosts_live"] == 2
        assert sup.stats["hosts_lost"] == 1
        mc = svc.counters()
        assert mc["evictions"] == 1 and mc["hosts_live"] == 2
        victim = infos["host-1"]
        assert await_true(lambda: proc_gone(agents["host-1"].pid))
        assert await_true(lambda: all(proc_gone(p)
                                      for p in victim["pids"]))
        replay = MembershipClient(server.addr).report(
            "host-1", victim["token"], victim["epoch"],
            {"replicas": victim["replicas"]})
        assert replay["status"] == "stale_epoch"
    finally:
        if sup is not None:
            sup.shutdown(drain=False)
        for a in agents.values():
            a.stop()
        server.shutdown()
    for p, rid in zip(prompts, rids):
        assert res[rid].tokens == jax_tokens(p, 4)
    leaked = [p for h, info in infos.items()
              for p in info["pids"] + [agents[h].pid] if not proc_gone(p)]
    assert not leaked, f"cluster processes outlived shutdown: {leaked}"
