"""The port's tiered embedding cache and CTR server against the JAX
package's.

- The caches alone: the port's `TieredEmbedCache` (device="cpu") and
  JAX's, each over its own copy of one scripted backing, give bit-equal
  rows and equal `counters()` at every step of scripted sequences:
  miss coalescing, the fast path, the staleness bound, the push feed, a
  watermark rewind, failover invalidation, `refresh_stale`, a host
  eviction retiring a device slot, and the overflow lookup.
- Static mode over the port's `HostOffloadEmbedding`, held against
  JAX's cache over a numpy backing with watermarks=None.
- `CtrServer.score`/`score_request` against JAX's with the same tower
  dict over the same rows (1e-6), rejections counted alike.
- Over real shards: a streaming trainer killed mid-stream plus a lost
  ACK, reformed, gives a table exactly equal to JAX's twin run and an
  equal shard version; a primary killed mid-read never serves a row
  staler than the bound.

Every PServerGroup a test starts is stopped by its `with` block."""

import json

import numpy as np
import pytest
import torch

from paddle_tpu.native.pserver import PServerGroup as JGroup
from paddle_tpu.native.taskqueue import TaskQueue as JQueue
from paddle_tpu.parallel.pserver_client import PServerClient as JClient
from paddle_tpu.parallel.pserver_client import (
    PServerEmbedding as JEmbedding)
from paddle_tpu.serve.ctr import CtrServer as JCtrServer
from paddle_tpu.serve.embed_cache import TieredEmbedCache as JCache
from paddle_tpu.testing.faults import FaultError as JFaultError
from paddle_tpu.testing.faults import FaultPlan as JFaultPlan
from paddle_tpu.train.online import StreamingTrainer as JStreaming
from paddle_tpu_torch.native.pserver import PServerGroup
from paddle_tpu_torch.native.taskqueue import TaskQueue
from paddle_tpu_torch.parallel.pserver_client import (PServerClient,
                                                      PServerEmbedding)
from paddle_tpu_torch.parallel.sparse import (HostOffloadEmbedding,
                                              LookupSurface)
from paddle_tpu_torch.serve import CtrServer, TieredEmbedCache, init_tower
from paddle_tpu_torch.testing.faults import FaultError, FaultPlan
from paddle_tpu_torch.train.online import StreamingTrainer

DIM = 4


class FakeBacking:
    """tests/test_embed_cache.py's injectable backing: a served vector
    `row * 10 + version` names the table version it came from;
    watermarks and failover counters are lists the script mutates."""

    def __init__(self, vocab=32, n_shards=2, dim=DIM, static=False):
        self.vocab, self.dim = vocab, dim
        self._n = n_shards
        self.rows_per = vocab // n_shards
        self.wms = [0] * n_shards
        self.fo = [0] * n_shards
        self.version = 0
        self.static = static
        self.pull_calls = []

    def value(self, r):
        return np.full(self.dim, 10.0 * r + self.version, np.float32)

    def pull_rows(self, table, ids):
        ids = np.asarray(ids).reshape(-1)
        self.pull_calls.append(sorted(int(i) for i in ids))
        rows = np.stack([self.value(int(r)) for r in ids])
        return rows.astype(np.float32), (None if self.static
                                         else list(self.wms))

    def owner_of(self, ids):
        ids = np.asarray(ids).reshape(-1)
        owner = ids // self.rows_per
        owner[(ids < 0) | (ids >= self.vocab)] = -1
        return owner.astype(np.int64)

    @property
    def n_shards(self):
        return self._n

    def poll_watermarks(self, table):
        return None if self.static else list(self.wms)

    def shard_failovers(self):
        return list(self.fo)


# -- scripted sequences over the fake backing ---------------------------------


def _seq_miss_coalescing(fake, cache, look):
    look([3, 17, 3, -1, 99, 17])
    look([3, 17, 5])


def _seq_fast_path(fake, cache, look):
    q = [5, 2, 9, -1, 5, 40]
    look(q)
    look(q)                                 # all resident: the fast path
    look([2, 9])


def _seq_staleness_bound(fake, cache, look):
    look([1, 2])
    fake.version = 1
    fake.wms[0] = 2                         # staleness 2 == the bound
    cache.refresh()
    look([1])
    fake.wms[0] = 3                         # one past it
    cache.refresh()
    look([1, 2])


def _seq_push_feed(fake, cache, look):
    look([2, 3, 20])
    fake.version = 5
    fake.wms[0] = 1
    cache.note_watermark(0, 1)              # a push ACK's feed
    look([2, 20])
    look([3])


def _seq_rewind(fake, cache, look):
    look([1, 20])
    fake.wms = [4, 4]
    cache.refresh()
    look([1, 20])
    cache.note_watermark(0, 1)              # rewind on shard 0
    look([1, 20])


def _seq_failover(fake, cache, look):
    look([1, 20])
    fake.fo[1] += 1
    look([1, 20])
    look([1, 20])


def _seq_refresh_stale(fake, cache, look):
    look([1, 2, 3, 17])
    fake.version = 7
    fake.wms[0] = 1
    cache.note_watermark(0, 1)
    cache.refresh_stale()
    look([1, 2, 3, 17])


def _seq_host_eviction(fake, cache, look):
    look([0, 1, 2, 3])
    look([4, 5, 6])                         # evicts 0..2 from the host tier
    look([0])
    look([5, 6, 0])


def _seq_overflow(fake, cache, look):
    look(list(range(12)))                   # 12 live rows, 4 slots
    look([1, 2])
    look(list(range(12)) + [-1])


SEQUENCES = {
    "miss_coalescing": (_seq_miss_coalescing, {}),
    "fast_path": (_seq_fast_path, {}),
    "staleness_bound": (_seq_staleness_bound, dict(max_staleness=2)),
    "push_feed": (_seq_push_feed, dict(max_staleness=0)),
    "rewind": (_seq_rewind, {}),
    "failover": (_seq_failover, {}),
    "refresh_stale": (_seq_refresh_stale, dict(max_staleness=0)),
    "host_eviction": (_seq_host_eviction, dict(hot_rows=4, host_rows=4)),
    "overflow": (_seq_overflow, dict(hot_rows=4, host_rows=24)),
}


def _run_sequence(make_cache, seq, kw, static=False):
    fake = FakeBacking(static=static)
    kw = dict(dict(hot_rows=16, host_rows=24), **kw)
    cache = make_cache(fake, **kw)
    steps = []

    def look(ids):
        out = cache.lookup(np.asarray(ids, np.int64))
        rows = (out.numpy() if isinstance(out, torch.Tensor)
                else np.asarray(out))
        steps.append((rows, cache.counters(), list(fake.pull_calls),
                      cache.watermarks()))

    seq(fake, cache, look)
    steps.append((None, cache.counters(), cache.reconcile(), None))
    return steps


def _port_cache(backing, **kw):
    return TieredEmbedCache(backing, device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_cache_sequence_matches_jax(name):
    seq, kw = SEQUENCES[name]
    want = _run_sequence(JCache, seq, kw)
    got = _run_sequence(_port_cache, seq, kw)
    assert len(got) == len(want)
    for i, ((gr, gc, gp, gw), (wr, wc, wp, ww)) in enumerate(zip(got,
                                                                 want)):
        if wr is not None:
            assert gr.dtype == np.float32 and gr.shape == wr.shape
            np.testing.assert_array_equal(gr, wr, err_msg=f"step {i}")
        assert gc == wc, f"step {i}"
        assert gp == wp and gw == ww, f"step {i}"
    assert got[-1][2]["ok"]


def test_cache_static_mode_matches_jax():
    """Watermarks None: static mode in both, entries never stale."""
    seq, kw = SEQUENCES["fast_path"]
    want = _run_sequence(JCache, seq, kw, static=True)
    got = _run_sequence(_port_cache, seq, kw, static=True)
    for (gr, gc, _, _), (wr, wc, _, _) in zip(got, want):
        if wr is not None:
            np.testing.assert_array_equal(gr, wr)
        assert gc == wc


def test_cache_over_host_offload_static_mode_matches_jax():
    """The port's cache over the port's HostOffloadEmbedding (static
    mode: pull_rows answers watermarks=None) against JAX's cache over a
    numpy backing of the same table with watermarks=None (JAX's own
    HostOffloadEmbedding fails inside this jax version, ROADMAP queue
    3)."""
    vocab = 16
    table = np.random.RandomState(0).standard_normal(
        (vocab, DIM)).astype(np.float32)
    emb = HostOffloadEmbedding(vocab, DIM, device="cpu")
    t = emb.place(torch.from_numpy(table))
    assert isinstance(emb, LookupSurface)

    class NumpyBacking:
        vocab, dim, n_shards = 16, DIM, 1

        def pull_rows(self, _, ids):
            ids = np.asarray(ids).reshape(-1)
            rows = np.zeros((ids.size, DIM), np.float32)
            ok = (ids >= 0) & (ids < vocab)
            rows[ok] = table[ids[ok]]
            return rows, None

        def owner_of(self, ids):
            return emb.owner_of(ids)

        def poll_watermarks(self, _):
            return None

        def shard_failovers(self):
            return [0]

    ours = TieredEmbedCache(emb, t, hot_rows=8, host_rows=12, device="cpu")
    theirs = JCache(NumpyBacking(), hot_rows=8, host_rows=12)
    for q in ([3, 0, 15, -1, 3], [3, 0, 15, -1, 3], list(range(10)),
              [3, 0, 15]):
        q = np.asarray(q, np.int64)
        got = ours.lookup(q).numpy()
        np.testing.assert_array_equal(got, np.asarray(theirs.lookup(q)))
        np.testing.assert_array_equal(got, emb.lookup(
            t, torch.from_numpy(q)).numpy())
        assert ours.counters() == theirs.counters()
    assert ours.counters()["hits_device"] > 0
    assert ours.reconcile()["ok"]


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fake = FakeBacking()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TieredEmbedCache(fake)
    cache = TieredEmbedCache(fake, device="cpu")
    assert cache._arena.device.type == "cpu"
    assert cache._arena.shape == (1024 + 1, DIM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CtrServer(cache, init_tower(0, DIM))
    CtrServer(cache, init_tower(0, DIM), device="cpu")


def test_the_arenas_zero_row_is_never_written():
    fake = FakeBacking()
    cache = TieredEmbedCache(fake, hot_rows=4, host_rows=8, fill_chunk=3,
                             device="cpu")
    for q in ([0, 1, 2, 3], [4, 5, 6, 7], [0, 1, -1]):
        cache.lookup(np.asarray(q))
        assert torch.count_nonzero(cache._arena[4]) == 0


# -- the CTR server -------------------------------------------------------------


def test_ctr_server_matches_jax():
    tower = init_tower(1, DIM)
    assert {k: v.dtype for k, v in tower.items()} == {
        k: np.float32 for k in ("w1", "b1", "w2", "b2")}
    outs = {}
    for side in ("jax", "torch"):
        fake = FakeBacking()
        if side == "jax":
            cache = JCache(fake, hot_rows=16, host_rows=24)
            srv = JCtrServer(cache, tower, slots=4, max_batch=2)
        else:
            cache = TieredEmbedCache(fake, hot_rows=16, host_rows=24,
                                     device="cpu")
            srv = CtrServer(cache, tower, slots=4, max_batch=2,
                            device="cpu")
        got = [srv.score(np.asarray([[1, 2, 3, -1], [5, 6, -1, -1]])),
               srv.score(np.asarray([[1, 2, 3, -1]])),
               srv.score(np.asarray([[-1, -1, -1, -1], [30, 31, 7, 7]]))]
        for bad in (np.zeros((3, 4), np.int64), np.zeros((1, 5), np.int64),
                    np.zeros(4, np.int64)):
            with pytest.raises(ValueError):
                srv.score(bad)
        with pytest.raises(ValueError):
            srv.score_request({"not_ids": 1})
        with pytest.raises(ValueError):
            srv.score_request([1])
        req = srv.score_request({"ids": [[1, 2, 3], [9, 10, 11]]})
        outs[side] = (got, req, srv.counters(), cache.counters())
    j, t = outs["jax"], outs["torch"]
    for a, b in zip(t[0], j[0]):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert t[0][1][0] == t[0][0][0]         # padding up changes nothing
    assert t[1]["batch"] == j[1]["batch"] == 2
    np.testing.assert_allclose(t[1]["scores"], j[1]["scores"], atol=1e-6)
    assert t[2] == j[2] and t[2]["rejected"] == 2     # ndim is no bucket
    assert t[3] == j[3]


# -- over real shards -----------------------------------------------------------

VOCAB = 16


def _dyadic_grad_fn(payload, rows, dim):
    """Payload-pure deltas with dyadic values: exact in any order."""
    del rows
    ids = np.asarray([int(payload["row"])], np.int64)
    return ids, np.full((1, dim), float(payload["delta"]), np.float32)


def _expected_table(init, tasks, lr=1.0):
    out = np.array(init, np.float32, copy=True)
    for t in tasks:
        out[t["row"]] -= np.float32(lr) * np.float32(t["delta"])
    return out


def _reform_run(port):
    """tests/test_embed_cache.py's reform twin on one package: the
    streaming trainer dies at its 5th step while a push ACK is lost;
    a fresh trainer with the same id finishes the stream."""
    Group, Client, Emb, Queue, Streaming, Plan, Err = (
        (PServerGroup, PServerClient, PServerEmbedding, TaskQueue,
         StreamingTrainer, FaultPlan, FaultError) if port else
        (JGroup, JClient, JEmbedding, JQueue, JStreaming, JFaultPlan,
         JFaultError))
    emb_kw = dict(device="cpu") if port else {}
    init = np.random.RandomState(5).standard_normal(
        (VOCAB, DIM)).astype(np.float32)
    with Group(VOCAB, DIM, n_shards=1, replicated=False) as grp:
        ack_plan = Plan(pserver_lost_ack_at=2)
        ack_plan.wrap_pserver_shard(grp.primaries[0])
        boot = Client(grp.specs, DIM, trainer_id=0)
        boot.register()
        boot.load_table(init)
        tasks = [{"row": i % VOCAB, "delta": 2.0 ** -(i % 6),
                  "seed": i, "vocab": VOCAB} for i in range(8)]
        q = Queue(timeout_ms=200, max_retries=4)
        for t in tasks:
            q.add_task(json.dumps(t).encode())

        def mk_trainer():
            client = Client(grp.specs, DIM, trainer_id=7)
            client.register()
            return Streaming(q, Emb(client, **emb_kw), None, lr=1.0,
                             grad_fn=_dyadic_grad_fn)

        t1 = mk_trainer()
        Plan(online_kill_step_at=4).wrap_online_trainer(t1)
        with pytest.raises(Err):
            t1.run(len(tasks))
        done_before = t1.stats["tasks_done"]
        t2 = mk_trainer()
        remaining = len(tasks) - done_before
        assert t2.run(remaining) == remaining
        got = boot.get_rows(np.arange(VOCAB))
        st = grp.primaries[0].stats()
        boot.close()
        q.close()
    return (got, _expected_table(init, tasks), done_before,
            ack_plan.count("pslostack"), st["duplicates"], st["version"],
            dict(t2.stats))


def test_reform_mid_stream_exactly_once_matches_jax():
    got, want, *rest = _reform_run(port=True)
    j_got, _, *j_rest = _reform_run(port=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j_got)
    assert rest == j_rest
    assert rest[1] == 1 and rest[2] >= 1 and rest[3] == 8 + 1


def test_streaming_trainer_default_grad_fn_matches_jax():
    """The default logistic head's pushes from rows the port's lookup
    hands back as a tensor: the same table as JAX's stream."""
    init = np.random.RandomState(1).standard_normal(
        (VOCAB, DIM)).astype(np.float32) * 0.1
    tables = []
    for port in (False, True):
        Group, Client, Emb, Queue, Streaming = (
            (PServerGroup, PServerClient, PServerEmbedding, TaskQueue,
             StreamingTrainer) if port else
            (JGroup, JClient, JEmbedding, JQueue, JStreaming))
        with Group(VOCAB, DIM, n_shards=2) as grp:
            with Client(grp.specs, DIM, trainer_id=3) as c:
                c.register()
                c.load_table(init)
                q = Queue()
                for i in range(4):
                    q.add_task(json.dumps({"seed": i, "batch": 8,
                                           "slots": 4,
                                           "vocab": VOCAB}).encode())
                emb = Emb(c, device="cpu") if port else Emb(c)
                tr = Streaming(q, emb, None, lr=0.5)
                assert tr.run(4) == 4
                assert tr.step() and tr.stats["passes_streamed"] == 1
                tables.append(c.fetch_table())
                q.close()
    np.testing.assert_allclose(tables[1], tables[0], rtol=0, atol=1e-6)


def test_shard_failover_never_serves_stale_beyond_bound():
    """tests/test_embed_cache.py's chaos read on the port: the shard-0
    primary killed on its 3rd get_rows; the cache notices the new
    authority and every served row equals the ground truth."""
    with PServerGroup(VOCAB, DIM, n_shards=2, replicated=True) as grp:
        plan = FaultPlan(pserver_kill_get_at=2)
        plan.wrap_pserver_shard(grp.primaries[0])
        push = PServerClient(grp.specs, DIM, trainer_id=0,
                             backoff_base=0.005)
        push.register()
        emb = PServerEmbedding(push, device="cpu")
        table = emb.init(2)
        init = push.get_rows(np.arange(VOCAB))
        read = PServerClient(grp.specs, DIM, trainer_id=1,
                             backoff_base=0.005)
        read.register()
        cache = TieredEmbedCache(PServerEmbedding(read, device="cpu"),
                                 table, hot_rows=8, host_rows=12,
                                 max_staleness=0, device="cpu")
        cache.bind_push_feed(push)
        tasks = [{"row": i % VOCAB, "delta": 2.0 ** -(i % 5)}
                 for i in range(12)]
        applied = []
        for i, t in enumerate(tasks):
            emb.apply_row_grads(table, np.asarray([t["row"]]),
                                np.full((1, DIM), t["delta"], np.float32),
                                1.0)
            applied.append(t)
            got = cache.lookup([t["row"], 1, VOCAB - 1]).numpy()
            want = _expected_table(init, applied)
            np.testing.assert_array_equal(got, want[[t["row"], 1,
                                                     VOCAB - 1]],
                                          err_msg=f"stale read at {i}")
        assert plan.count("psgetkill") == 1
        assert read.shard_failovers()[0] >= 1
        assert cache.counters()["invalidations_failover"] >= 1
        assert cache.reconcile()["ok"]
        push.close()
        read.close()
