"""The port's parameter-server tier against the JAX package's: the wire
module and the shard/membership copies, one scripted shard sequence on
both tiers, each package's client against the other's shards,
`PServerEmbedding`, a primary killed mid-pass, `ResilientTrainer` with a
`pserver_client` through a shard kill, and the membership-resolved
topology (`from_membership`, `refresh_topology`, the gang supervisor's
membership mirror).

Every group, shard and server a test starts is stopped in a `with`
block or a `finally`."""

import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu import optim as joptim
from paddle_tpu.cluster import membership as JM
from paddle_tpu.native import pserver as JPS
from paddle_tpu.ops import losses as JLS
from paddle_tpu.parallel import pserver_client as JPC
from paddle_tpu.testing import faults as JF
from paddle_tpu.train import Trainer as JTrainer
from paddle_tpu.train import events as JE
from paddle_tpu.train import resilience as JR
from paddle_tpu_torch.cluster import membership as TM
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.native import pserver as TPS
from paddle_tpu_torch.nn import layers as TNL
from paddle_tpu_torch.nn import module as TNM
from paddle_tpu_torch.obs import MetricsRegistry, Tracer
from paddle_tpu_torch.ops import losses as TLS
from paddle_tpu_torch.optim import optimizers as TO
from paddle_tpu_torch.parallel import pserver_client as TPC
from paddle_tpu_torch.testing import faults as TF
from paddle_tpu_torch.train import events as TE
from paddle_tpu_torch.train.resilience import ResilientTrainer
from paddle_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 4

JAX = types.SimpleNamespace(name="jax", PS=JPS, PC=JPC, F=JF, M=JM)
TORCH = types.SimpleNamespace(name="torch", PS=TPS, PC=TPC, F=TF, M=TM)


def _client(side, specs, trainer_id=0, **kw):
    kw.setdefault("backoff_base", 0.005)
    kw.setdefault("backoff_max", 0.1)
    kw.setdefault("timeout", 5.0)
    return side.PC.PServerClient(specs, DIM, trainer_id=trainer_id, **kw)


def _table(vocab, seed=0):
    return np.random.RandomState(seed).rand(vocab, DIM).astype(np.float32)


def _push_schedule(vocab, steps, seed=3):
    """(ids, grads) per step; every other step carries -1 and
    out-of-range padding ids, which the push drops."""
    r = np.random.RandomState(seed)
    out = []
    for i in range(steps):
        ids = r.randint(0, vocab, 5).astype(np.int64)
        if i % 2:
            ids[1], ids[3] = -1, vocab + 2
        out.append((ids, r.rand(5, DIM).astype(np.float32)))
    return out


def _reference_apply(table, schedule, lr=0.1):
    out = table.astype(np.float32).copy()
    for ids, grads in schedule:
        ok = (ids >= 0) & (ids < table.shape[0])
        np.add.at(out, ids[ok], (-lr * grads[ok]).astype(np.float32))
    return out


def _restart_on(side, port, row_lo, row_hi, **kw):
    """A shard back on a just-killed shard's port (the dead listener's
    fd release can lag its kill by a scheduler tick)."""
    deadline = time.monotonic() + 5.0
    while True:
        try:
            return side.PS.PServerShard(0, row_lo, row_hi, DIM, port=port,
                                        **kw)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.02)


# -- the copies ----------------------------------------------------------------


def _src(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def test_wire_copy_is_the_original_source():
    assert _src("paddle_tpu_torch", "wire.py") == _src("paddle_tpu",
                                                       "wire.py")


@pytest.mark.parametrize("rel", [("native", "pserver.py"),
                                 ("cluster", "membership.py")])
def test_copies_differ_only_by_the_import_prefix(rel):
    ours = _src("paddle_tpu_torch", *rel)
    assert "paddle_tpu." not in ours
    assert ours == _src("paddle_tpu", *rel).replace("paddle_tpu.",
                                                    "paddle_tpu_torch.")


# -- one scripted sequence on both tiers ---------------------------------------


def _scripted(side, tmp):
    """Register, load, get (with padding ids), pushes with padding ids,
    a replayed (duplicate) epoch, a lost ACK, finish_pass, a snapshot,
    a backup outage and its full resync, the primary killed and
    restarted from its snapshot and its replica. Returns every
    observable result in order."""
    out = {}
    vocab = 16
    primary, backup, spec = side.PS.start_shard_pair(
        0, 0, 8, DIM, snapshot_dir=os.path.join(tmp, "snap"), name="s0")
    solo = side.PS.PServerShard(1, 8, 16, DIM)
    specs = [spec, side.PS.ShardSpec(1, 8, 16, [solo.addr])]
    plan = side.F.FaultPlan(pserver_lost_ack_at=1)
    plan.wrap_pserver_shard(primary)
    backup2 = restarted = None
    try:
        with _client(side, specs) as c:
            c.register()
            table = _table(vocab)
            c.load_table(table)
            out["get"] = c.get_rows(np.asarray([0, 7, 8, 15, -1, 99]))
            sched = _push_schedule(vocab, 4)
            for ids, grads in sched:
                c.push_row_grads(ids, grads, 0.1)
            # replay shard 0's last epoch: DUP, applied once
            c._epochs[0] -= 1
            c.push_row_grads(np.asarray([1, 2]), np.ones((2, DIM),
                                                          np.float32), 0.1)
            out["after_dup"] = c.fetch_table()
            out["finish"] = c.finish_pass(timeout_s=10.0)
            out["pass_state"] = [c.pass_state(0), c.pass_state(1)]
            primary.snapshot()
            backup.kill()
            extra = _push_schedule(vocab, 3, seed=9)
            c.push_row_grads(*extra[0], 0.1)        # degraded: no backup
            backup2 = _restart_on(side, backup.addr[1], 0, 8)
            c.push_row_grads(*extra[1], 0.1)        # full-state resync
            c.push_row_grads(*extra[2], 0.1)        # incremental again
            out["resync"] = (backup2.stats()["repl_resyncs"],
                             backup2.state.version)
            out["backup_rows"] = backup2.state.rows.copy()
            out["table"] = c.fetch_table()
            out["shard_stats"] = c.shard_stats()
            out["client_stats"] = dict(c.stats)
            out["watermarks"] = list(c.watermarks)
            out["epochs"] = list(c._epochs)
        out["fired"] = list(plan.fired)
        primary.kill()                              # no final snapshot
        restarted = side.PS.PServerShard(
            0, 0, 8, DIM, name="s0-primary",
            snapshot_dir=os.path.join(tmp, "snap"), sync_from=backup2.addr,
            replica_addr=backup2.addr)
        out["restart"] = (restarted.restored_from is not None,
                          restarted.synced_from_peer,
                          restarted.state.version,
                          restarted.state.rows.copy(),
                          dict(restarted.state.epochs))
    finally:
        for sh in (restarted, backup2, primary, backup, solo):
            if sh is not None:
                sh.stop()
    out["expected"] = _reference_apply(
        _reference_apply(table, sched), extra)
    return out


def _assert_same(a, b, what=""):
    """Equal values, arrays bit for bit with their dtypes."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _assert_same(x, y, what)
    else:
        assert a == b, what


def test_scripted_sequence_matches_jax(tmp_path):
    j = _scripted(JAX, str(tmp_path / "jax"))
    t = _scripted(TORCH, str(tmp_path / "torch"))
    _assert_same(t, j)
    np.testing.assert_array_equal(t["table"], t["expected"])
    np.testing.assert_array_equal(t["backup_rows"], t["table"][:8])
    assert t["client_stats"]["duplicate_acks"] == 2   # replay + lost ACK
    assert t["fired"] == ["pslostack@1"]
    assert t["restart"][:2] == (True, True)


# -- cross-package wire interop ------------------------------------------------


@pytest.mark.parametrize("client_side,group_side", [(TORCH, JAX),
                                                    (JAX, TORCH)],
                         ids=["torch_client_jax_shards",
                              "jax_client_torch_shards"])
def test_client_talks_to_the_other_packages_shards(client_side, group_side):
    vocab = 16
    table = _table(vocab, seed=4)
    sched = _push_schedule(vocab, 5)
    with group_side.PS.PServerGroup(vocab, DIM, n_shards=2) as g:
        plan = group_side.F.FaultPlan(pserver_lost_ack_at=2)
        plan.wrap_pserver_shard(g.primaries[1])
        with _client(client_side, g.specs) as c:
            c.register()
            c.load_table(table)
            rows = c.get_rows(np.asarray([3, 12, -1]))
            for ids, grads in sched:
                c.push_row_grads(ids, grads, 0.1)
            assert c.finish_pass(timeout_s=10.0) == 1
            assert c.poll_watermarks() == [s["version"]
                                           for s in c.shard_stats()]
            got = c.fetch_table()
            assert c.stats["duplicate_acks"] == 1
        assert plan.count("pslostack") == 1
        for p, b in zip(g.primaries, g.backups):
            np.testing.assert_array_equal(p.state.rows, b.state.rows)
    np.testing.assert_array_equal(rows[:2], table[[3, 12]])
    np.testing.assert_array_equal(rows[2], np.zeros(DIM, np.float32))
    np.testing.assert_array_equal(got, _reference_apply(table, sched))


# -- PServerEmbedding ----------------------------------------------------------


def test_pserver_embedding_matches_jax():
    vocab = 16
    table = _table(vocab, seed=6)
    ids = np.asarray([0, 9, 15, -1, 9, 40], np.int64)
    grads = np.random.RandomState(5).rand(6, DIM).astype(np.float32)
    got = {}
    for side in (JAX, TORCH):
        with side.PS.PServerGroup(vocab, DIM, n_shards=2,
                                  replicated=False) as g:
            with _client(side, g.specs) as c:
                c.register()
                c.load_table(table)
                if side is JAX:
                    emb = JPC.PServerEmbedding(c)
                    vecs = np.asarray(emb.lookup(None, jnp.asarray(ids)))
                    out, over = emb.alltoall_lookup(None, ids,
                                                    return_overflow=True)
                    emb.apply_row_grads(None, jnp.asarray(ids),
                                        jnp.asarray(grads), 0.3)
                else:
                    emb = TPC.PServerEmbedding(c, device="cpu")
                    t = emb.lookup(None, torch.from_numpy(ids))
                    assert t.dtype == torch.float32 and t.device.type == "cpu"
                    vecs = t.numpy()
                    out, over = emb.alltoall_lookup(None, ids,
                                                    return_overflow=True)
                    assert over.dtype == torch.int64
                    emb.apply_row_grads(None, torch.from_numpy(ids),
                                        torch.from_numpy(grads), 0.3)
                got[side.name] = (vecs, np.asarray(out), int(over),
                                  c.fetch_table(),
                                  emb.pull_rows(None, ids[:3]),
                                  emb.owner_of(ids).tolist(),
                                  emb.n_shards, emb.shard_failovers())
    j, t = got["jax"], got["torch"]
    for a, b in zip(j[:4], t[:4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j[4][0], t[4][0])
    assert j[4][1] == t[4][1] and j[5:] == t[5:]
    np.testing.assert_array_equal(t[0][3], np.zeros(DIM, np.float32))


def test_pserver_embedding_init_loads_a_seeded_host_table():
    with TPS.PServerGroup(8, DIM, n_shards=2) as g:
        with _client(TORCH, g.specs) as c:
            emb = TPC.PServerEmbedding(c, device="cpu", init_scale=0.5)
            h = emb.init(3)
            assert h.shape == (8, DIM)
            gen = torch.Generator()
            gen.manual_seed(3)
            want = (torch.randn((8, DIM), generator=gen) * 0.5).numpy()
            np.testing.assert_array_equal(c.fetch_table(), want)
            np.testing.assert_array_equal(g.backups[0].state.rows,
                                          want[:4])


def test_pserver_embedding_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class _Stub:
        num_rows, dim, n_shards = 8, DIM, 1

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPC.PServerEmbedding(_Stub())
    assert TPC.PServerEmbedding(_Stub(), device="cpu").device.type == "cpu"


# -- chaos: a primary killed mid-pass -----------------------------------------


def _pass(side, specs, table, sched):
    with _client(side, specs) as c:
        c.register()
        c.load_table(table)
        for ids, grads in sched:
            c.push_row_grads(ids, grads, 0.1)
        c.finish_pass(timeout_s=10.0)
        return c.fetch_table(), dict(c.stats)


def test_primary_killed_midpass_is_bit_identical_to_the_unfaulted_twin():
    vocab = 32
    sched = _push_schedule(vocab, 8)
    table = _table(vocab)
    with JPS.PServerGroup(vocab, DIM, n_shards=2) as g:
        jax_table, _ = _pass(JAX, g.specs, table, sched)
    with TPS.PServerGroup(vocab, DIM, n_shards=2) as g:
        unfaulted, _ = _pass(TORCH, g.specs, table, sched)
    with TPS.PServerGroup(vocab, DIM, n_shards=2) as g:
        kill = TF.FaultPlan(pserver_kill_push_at=2)
        ack = TF.FaultPlan(pserver_lost_ack_at=4)
        kill.wrap_pserver_shard(g.primaries[0])
        ack.wrap_pserver_shard(g.primaries[1])
        faulted, stats = _pass(TORCH, g.specs, table, sched)
        assert kill.count("pskill") == 1 and ack.count("pslostack") == 1
        assert g.primaries[0].killed
        assert stats["reregistrations"] >= 1
        assert stats["duplicate_acks"] >= 1
        np.testing.assert_array_equal(g.backups[0].state.rows,
                                      unfaulted[:16])
    np.testing.assert_array_equal(faulted, unfaulted)
    np.testing.assert_array_equal(unfaulted, jax_table)


# -- ResilientTrainer(pserver_client=...) through a shard kill ------------------


def _resilient_run(side, specs, table0, params0, ckpt_dir, id_sched):
    """tests/test_pserver.py::test_resilient_trainer_through_shard_kill on
    one package: rows looked up from the tier feed a Dense(3); every
    EndIteration pushes row gradients; the client is the trainer's
    pserver_client (its pushes and pulls ride the step spans)."""
    steps = len(id_sched)
    with _client(side, specs) as c:
        c.register()
        c.load_table(table0)
        if side is JAX:
            emb = JPC.PServerEmbedding(c)
            tr = JTrainer(jnn.Sequential([jnn.Dense(3, name="out")]),
                          lambda o, y: jnp.mean(
                              JLS.softmax_cross_entropy(o, y)),
                          joptim.sgd(0.1))
            state = tr.init_state(jnn.ShapeSpec((4, DIM)))
            state = state._replace(params=jax.tree.map(jnp.asarray,
                                                       params0))
            from paddle_tpu.obs import Tracer as JTracer

            tracer = JTracer()
            rt = JR.ResilientTrainer(tr, ckpt_dir, pserver_client=c,
                                     tracer=tracer)
            E = JE
        else:
            emb = TPC.PServerEmbedding(c, device="cpu")
            tr = Trainer(TNM.Sequential([TNL.Dense(3, name="out")]),
                         lambda o, y: torch.mean(
                             TLS.softmax_cross_entropy(o, y)),
                         TO.sgd(0.1), device="cpu")
            state = tr.init_state(TNM.ShapeSpec((4, DIM)))
            state = state._replace(params=params_from_numpy(
                params0, device="cpu"))
            tracer = Tracer()
            rt = ResilientTrainer(tr, ckpt_dir, pserver_client=c,
                                  tracer=tracer)
            E = TE

        def factory():
            for i in range(steps):
                vecs = np.asarray(emb.lookup(None, id_sched[i]))
                yield vecs, (id_sched[i] % 3).astype(np.int64)

        def on_event(ev):
            if isinstance(ev, E.EndIteration):
                i = ev.batch_id
                g = np.full((4, DIM), (i + 1) / 10.0, np.float32)
                emb.apply_row_grads(None, id_sched[i], g, 0.5)

        final = rt.run(state, factory, num_passes=1, event_handler=on_event)
        # the pushes (at EndIteration) and the next batch's pulls come
        # after their step's span closed: the hook lands them as late
        # events on it, in both packages
        obs = (tracer.counters(), dict(c.stats))
        c.finish_pass(timeout_s=10.0)
        params = {k: {kk: np.asarray(v) for kk, v in d.items()}
                  for k, d in final.params.items()}
        names = None
        if side is TORCH:
            reg = MetricsRegistry()
            rt.bind_metrics(reg)
            names = {r["name"] for r in reg.snapshot()["series"]}
        return params, c.fetch_table(), obs, names


@pytest.fixture(scope="module")
def jax_ready(tmp_path_factory):
    """JAX's first jit and its (orbax) checkpoint manager warmed up
    before the resilient run times its own steps."""
    from paddle_tpu.train.checkpoint import CheckpointManager as JCM
    from paddle_tpu.train.state import TrainState as JTS

    jax.jit(lambda a: a + 1)(jnp.zeros(2)).block_until_ready()
    mgr = JCM(str(tmp_path_factory.mktemp("warm")))
    mgr.save(JTS(params={"w": jnp.zeros(2)}, model_state={}, opt_state={},
                 step=jnp.zeros((), jnp.int32)))
    mgr.all_steps()
    mgr.close()


def test_resilient_trainer_through_shard_kill_matches_jax(tmp_path,
                                                          jax_ready):
    vocab, steps = 8, 6
    id_sched = [np.random.RandomState(100 + i).randint(0, vocab, 4)
                .astype(np.int64) for i in range(steps)]
    table0 = _table(vocab, seed=2) * 0.1
    rs = np.random.RandomState(7)
    params0 = {"out": {"kernel": rs.standard_normal((DIM, 3)).astype(
        np.float32) * 0.5, "bias": np.zeros(3, np.float32)}}
    runs = {}
    for side, faulted in ((TORCH, False), (TORCH, True), (JAX, True)):
        with side.PS.PServerGroup(vocab, DIM, n_shards=1) as g:
            plan = None
            if faulted:
                plan = side.F.FaultPlan(pserver_kill_push_at=2)
                plan.wrap_pserver_shard(g.primaries[0])
            runs[(side.name, faulted)] = _resilient_run(
                side, g.specs, table0, params0,
                str(tmp_path / f"{side.name}{faulted}"), id_sched)
            if faulted:
                assert plan.count("pskill") == 1
                assert g.primaries[0].killed
    t_params, t_table, t_obs, names = runs[("torch", True)]
    r_params, r_table, _, _ = runs[("torch", False)]
    j_params, j_table, j_obs, _ = runs[("jax", True)]
    np.testing.assert_array_equal(t_table, r_table)
    np.testing.assert_array_equal(t_table, j_table)
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(t_params["out"][k], r_params["out"][k])
        np.testing.assert_allclose(t_params["out"][k], j_params["out"][k],
                                   rtol=1e-5, atol=1e-5)
    # the seam: the client's ledger under {prefix}_pserver; the client's
    # events reach the step spans through obs_hook as JAX's do
    assert "train_pserver_pushes" in names
    assert t_obs == j_obs
    assert t_obs[0]["late_events"] == steps + steps - 1


# -- membership-resolved topology ---------------------------------------------


class _FakeMembership:
    def __init__(self, view):
        self.v = view

    def view(self):
        return self.v


def test_shard_specs_from_view_merges_roles_and_rejects_stale_rows():
    view = TM.ClusterView(epoch=3, hosts={
        "h0": {"shards": [{"shard_id": 0, "row_lo": 0, "row_hi": 8,
                           "endpoints": [["127.0.0.1", 9001]],
                           "role": "primary"}]},
        "h1": {"shards": [{"shard_id": 0, "row_lo": 0, "row_hi": 8,
                           "endpoints": [["127.0.0.1", 9002]],
                           "role": "backup"},
                          {"shard_id": 1, "row_lo": 8, "row_hi": 16,
                           "endpoints": [["127.0.0.1", 9003]]}]},
    })
    specs = TPC.shard_specs_from_view(view)
    jspecs = JPC.shard_specs_from_view(JM.ClusterView.from_json(
        view.to_json()))
    assert [repr(s) for s in specs] == [repr(s) for s in jspecs]
    assert specs[0].endpoints == [("127.0.0.1", 9001),
                                  ("127.0.0.1", 9002)]
    view.hosts["h1"]["shards"][0]["row_hi"] = 12    # stale inventory
    with pytest.raises(ValueError, match="stale"):
        TPC.shard_specs_from_view(view)


def test_pserver_client_resolves_and_refreshes_from_membership():
    v1 = TM.ClusterView(epoch=1, hosts={
        "h0": {"shards": [{"shard_id": 0, "row_lo": 0, "row_hi": 8,
                           "endpoints": [["127.0.0.1", 9001]]}]}})
    mem = _FakeMembership(v1)
    client = TPC.PServerClient.from_membership(mem, dim=4)
    assert client.num_rows == 8
    assert client.refresh_topology() is False
    mem.v = TM.ClusterView(epoch=2, hosts={
        "h1": {"shards": [{"shard_id": 0, "row_lo": 0, "row_hi": 8,
                           "endpoints": [["127.0.0.1", 9002]]}]}})
    assert client.refresh_topology() is True
    assert client._conns[0].endpoints == [("127.0.0.1", 9002)]
    assert client.shard_failovers() == [1]
    mem.v = TM.ClusterView(epoch=3, hosts={
        "h1": {"shards": [{"shard_id": 0, "row_lo": 0, "row_hi": 16,
                           "endpoints": [["127.0.0.1", 9002]]}]}})
    with pytest.raises(ValueError, match="layout"):
        client.refresh_topology()
    with pytest.raises(RuntimeError, match="from_membership"):
        TPC.PServerClient(TPC.shard_specs_from_view(v1),
                          dim=4).refresh_topology()


def test_client_from_a_membership_server_fails_over_on_refresh():
    """A real MembershipServer (the port's) answering a JAX
    MembershipClient and the port's: the pserver hosts register their
    shard inventory, the client resolves its chain from the view and,
    after the primary's host re-reports only the backup, re-points."""
    svc = TM.MembershipService(default_ttl_s=30.0)
    server = TM.MembershipServer(svc).start()
    try:
        with TPS.PServerGroup(8, DIM, n_shards=1) as g:
            p, b = g.primaries[0].addr, g.backups[0].addr
            mc = TM.MembershipClient(server.addr)
            reg = mc.register("h0", {"shards": [
                {"shard_id": 0, "row_lo": 0, "row_hi": 8,
                 "endpoints": [list(p)], "role": "primary"},
                {"shard_id": 0, "row_lo": 0, "row_hi": 8,
                 "endpoints": [list(b)], "role": "backup"}]})
            assert JM.MembershipClient(server.addr).view().epoch == \
                reg["epoch"] == 1
            client = TPC.PServerClient.from_membership(
                mc, DIM, backoff_base=0.005, timeout=5.0)
            try:
                assert client._conns[0].endpoints == [p, b]
                client.register()
                client.load_table(_table(8))
                mc.report("h0", reg["token"], reg["epoch"], {"shards": [
                    {"shard_id": 0, "row_lo": 0, "row_hi": 8,
                     "endpoints": [list(b)], "role": "primary"}]})
                assert client.refresh_topology() is True
                np.testing.assert_array_equal(
                    client.get_rows(np.arange(8)), _table(8))
                assert client._conns[0].active_endpoint == b
            finally:
                client.close()
    finally:
        server.shutdown()


def _membership_script(M, clock):
    svc = M.MembershipService(default_ttl_s=5.0, clock=clock)
    out = [svc.register("a", {"x": 1}), svc.register("b")]
    clock.advance(3.0)
    out.append(svc.renew("a", out[0]["token"], svc.epoch))
    out.append(svc.renew("b", 999, svc.epoch))              # stale token
    out.append(svc.report("a", out[0]["token"], svc.epoch, {"x": 2}))
    clock.advance(3.0)
    out.append(svc.tick())                                  # b expires
    out.append(svc.renew("b", out[1]["token"], svc.epoch))
    out.append(sorted(svc.view().hosts))
    out.append(svc.deregister("a", out[0]["token"], 1))     # stale epoch
    out.append(svc.deregister("a", out[0]["token"], svc.epoch))
    out.append((svc.epoch, svc.view().to_json(), svc.counters()))
    return out


def test_membership_service_matches_jax():
    assert _membership_script(TM, TF.ManualClock()) == _membership_script(
        JM, JF.ManualClock())


def test_gang_supervisor_membership_mirror(tmp_path):
    """tests/test_cluster.py's mirror test on the port's GangSupervisor
    over the port's MembershipService."""
    from paddle_tpu_torch.parallel.launch import GangSupervisor

    clock = TF.ManualClock()
    svc = TM.MembershipService(default_ttl_s=5.0, clock=clock)
    sup = GangSupervisor(
        "paddle_tpu_torch.testing.gang:unused",
        workdir=str(tmp_path / "w"), checkpoint_dir=str(tmp_path / "c"),
        num_processes=2, total_steps=1, heartbeat_timeout_s=5.0,
        membership=svc, host_prefix="gang")
    sup._membership_register(2, "file:///unused")
    assert sorted(svc.view().hosts) == ["gang-0", "gang-1"]
    assert svc.view().hosts["gang-0"]["rank"] == 0
    assert sup._membership_lost([0, 1]) == []
    clock.advance(3.0)
    sup._membership_renew(0)
    clock.advance(3.0)
    assert sup._membership_lost([0, 1]) == [1]
    assert sorted(svc.view().hosts) == ["gang-0"]
    sup.membership_evictions += 1
    assert sup.counters()["membership_evictions"] == 1
    sup._membership_deregister()
    assert svc.view().hosts == {} and sup._member_creds == {}


def test_membership_client_keeps_the_gang_mirror_across_processes(tmp_path):
    """The mirror through a MembershipServer: the supervisor holds a
    MembershipClient, the view is read back by another client."""
    from paddle_tpu_torch.parallel.launch import GangSupervisor

    svc = TM.MembershipService(default_ttl_s=30.0)
    server = TM.MembershipServer(svc).start()
    try:
        sup = GangSupervisor(
            "paddle_tpu_torch.testing.gang:unused",
            workdir=str(tmp_path / "w"),
            checkpoint_dir=str(tmp_path / "c"), num_processes=2,
            total_steps=1, membership=TM.MembershipClient(server.addr))
        sup._membership_register(2, "file:///unused")
        view = JM.MembershipClient(server.addr).view()
        assert sorted(view.hosts) == ["gang-0", "gang-1"]
        sup._membership_renew(1)
        assert svc.counters()["renews"] == 1
        sup._membership_deregister()
        assert TM.MembershipClient(server.addr).view().hosts == {}
    finally:
        server.shutdown()
