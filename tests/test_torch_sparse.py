"""The port's sharded sparse embeddings (`parallel.sparse`,
`ops.embedding`) against the JAX package: every case of
tests/test_sparse_parallel.py that touches `sparse.py` (the lookups
against dense, gradients, bag combiners, `rowwise_sgd_update`,
`unique_rows_grad` and its overflow flag, the all-to-all lookup with
out-of-range ids, skewed ids and capacity overflow, the gradient
through the exchange, the row-gradient push, the module end to end) on
a 4-rank gloo group at model-axis sizes 2 and 4 and a 2 x 2 mesh, each
against JAX's function on its CPU mesh of the same shape; and
`HostOffloadEmbedding` against JAX's class. Gathers are exact, sums
within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import mesh as mesh_lib
from paddle_tpu.ops import embedding as JE
from paddle_tpu.parallel import sparse as JS

from paddle_tpu_torch.ops import embedding as TE
from paddle_tpu_torch.parallel import sparse as TS

import torch_dist
from torch_dist_slice import SPARSE_MESHES

SUM = dict(rtol=1e-6, atol=1e-6)


def _table(vocab=32, dim=6, seed=0):
    return np.asarray(jax.random.normal(jax.random.key(seed), (vocab, dim),
                                        jnp.float32))


def _payload():
    r = np.random.RandomState(0)
    emb = JS.ShardedEmbedding(vocab=30, dim=4, mesh=_jmesh(1, 4),
                              init_scale=0.1)
    return dict(
        table=_table(), table31=_table(31), table16=_table(16, 4),
        table32x6=_table(32, 6, seed=5),
        ids57=r.randint(0, 32, (5, 7)),
        gids=np.asarray([1, 1, 5, 31]),
        cot=np.asarray(jax.random.normal(jax.random.key(1), (4, 6),
                                         jnp.float32)),
        bag_ids=np.asarray([0, 3, 3, 9, 20]),
        bag_seg=np.asarray([0, 0, 1, 1, 1]),
        rw_ids=np.asarray([2, 2, 17, 30]),
        rw_grads=np.asarray(jax.random.normal(jax.random.key(2), (4, 6),
                                              jnp.float32)),
        ids24=np.random.RandomState(1).randint(0, 32, 24),
        oor=np.asarray([0, -1, 31, 32, 5, -7, 12, 99]),
        skew=np.random.RandomState(2).randint(0, 8, 16),
        zeros16=np.zeros(16, np.int64),
        g_ids=np.random.RandomState(3).randint(0, 16, 8),
        g_w=np.random.RandomState(4).randn(8, 4).astype(np.float32),
        push_ids=np.random.RandomState(5).randint(0, 32, 16),
        push_grads=np.random.RandomState(5).randn(16, 6).astype(np.float32),
        e2e_table=np.asarray(emb.init(jax.random.key(0))),
        e2e_ids=np.asarray([1, 7, 19]),
        e2e_target=np.asarray(jax.random.normal(jax.random.key(3), (4,),
                                                jnp.float32)))


def _jmesh(data, model):
    return mesh_lib.build_mesh(mesh_lib.MeshConfig(data=data, model=model),
                               devices=jax.devices()[:data * model])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    payload = _payload()
    out = torch_dist.run_group(4, "torch_dist_slice:sparse_cases", payload,
                               tmp_path_factory.mktemp("sparse"))
    return payload, out


@pytest.fixture(scope="module")
def jref(setup):
    """JAX's results on its own test mesh (data 2 x model 4; all but the
    capacity-overflow count are the same on every mesh shape, as JAX's
    tests hold them against dense) and its overflow count per model
    axis size."""
    payload, _ = setup
    mesh = _jmesh(2, 4)
    a = lambda k: jnp.asarray(payload[k])
    sh = lambda k="table": JS.shard_rows(a(k), mesh)
    jit = lambda f, *args: jax.jit(f)(*args)
    ref = {"lookup": jit(lambda t, i: JS.sharded_lookup(t, i, mesh), sh(),
                         a("ids57")),
           "lookup_grad": jit(jax.grad(lambda t: jnp.vdot(JS.sharded_lookup(
               t, a("gids"), mesh), a("cot"))), sh()),
           "rowwise": jit(lambda t: JS.rowwise_sgd_update(
               t, a("rw_ids"), a("rw_grads"), 0.1, mesh), sh()),
           "a2a": jit(lambda t, i: JS.alltoall_lookup(t, i, mesh), sh(),
                      a("ids24")),
           "a2a_oor": jit(lambda t, i: JS.alltoall_lookup(t, i, mesh), sh(),
                          a("oor")),
           "a2a_grad": jit(jax.grad(lambda t: jnp.sum(JS.alltoall_lookup(
               t, a("g_ids"), mesh) * a("g_w"))), sh("table16")),
           "push": jit(lambda t: JS.alltoall_push_row_grads(
               t, a("push_ids"), a("push_grads"), 0.3, mesh),
               sh("table32x6"))}
    bag = lambda comb: lambda t: JS.sharded_embedding_bag(
        t, a("bag_ids"), a("bag_seg"), 2, mesh, combiner=comb)
    ref.update(bag_sum=jit(bag("sum"), sh()),
               bag_mean=jit(bag("mean"), sh()),
               bag_sqrtn=jit(bag("sqrtn"), sh()))
    skew, ov = jit(lambda t: JS.alltoall_lookup(
        t, a("skew"), mesh, return_overflow=True), sh())
    ref["a2a_skew"], ref["a2a_skew_overflow"] = skew, int(ov)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    with pytest.raises(ValueError) as e:
        JS.shard_rows(a("table31"), mesh)
    ref["not_divisible"] = str(e.value).replace("size 4", "size {n}")
    cap1 = lambda m: lambda t: JS.alltoall_lookup(
        t, jnp.asarray(payload["zeros16"], jnp.int32), m, capacity=1,
        return_overflow=True)
    m2, m4 = _jmesh(1, 2), _jmesh(1, 4)
    capped = {2: jit(cap1(m2), JS.shard_rows(a("table"), m2)),
              4: jit(cap1(m4), JS.shard_rows(a("table"), m4))}
    for n, (got, ov) in capped.items():
        ref[f"a2a_cap{n}"], ref[f"a2a_cap_overflow{n}"] = (np.asarray(got),
                                                           int(ov))
    emb = JS.ShardedEmbedding(vocab=30, dim=4, mesh=mesh, init_scale=0.1)
    table = JS.shard_rows(a("e2e_table"), mesh)
    target, ids = a("e2e_target"), a("e2e_ids")
    grads = jax.jit(lambda t: jax.value_and_grad(
        lambda r: jnp.mean((r - target) ** 2))(emb.lookup(t, ids)))
    apply = jax.jit(lambda t, rg: emb.apply_row_grads(t, ids, rg, lr=0.5))
    losses = []
    for _ in range(20):
        loss, rg = grads(table)
        losses.append(float(loss))
        table = apply(table, rg)
    ref["e2e_losses"], ref["e2e_table"] = losses, np.asarray(table)
    return ref


def _each(out, shape):
    data, model = shape
    return [out[r][shape] for r in range(data * model)]


@pytest.mark.parametrize("shape", SPARSE_MESHES)
def test_sharded_lookup_and_gradient_match_jax(setup, jref, shape):
    _, out = setup
    for got in _each(out, shape):
        np.testing.assert_array_equal(got["lookup"], jref["lookup"])
        np.testing.assert_allclose(got["lookup_grad"], jref["lookup_grad"],
                                   **SUM)


@pytest.mark.parametrize("shape", SPARSE_MESHES)
def test_bag_combiners_and_rowwise_update_match_jax(setup, jref, shape):
    payload, out = setup
    for got in _each(out, shape):
        for comb in ("sum", "mean", "sqrtn"):
            np.testing.assert_allclose(got[f"bag_{comb}"],
                                       jref[f"bag_{comb}"], **SUM)
        assert "combiner" in got["bag_bogus"]
        np.testing.assert_allclose(got["rowwise"], jref["rowwise"], **SUM)
        np.testing.assert_array_equal(got["rowwise"][0], payload["table"][0])
        assert got["not_divisible"] == jref["not_divisible"].format(
            n=shape[1])


@pytest.mark.parametrize("shape", SPARSE_MESHES)
def test_alltoall_lookup_matches_jax(setup, jref, shape):
    """Dense ids, out-of-range ids (zero rows), ids all owned by one
    shard (lossless at the default capacity) and capacity 1 (JAX's
    overflow count at the same axis size, the kept slots right)."""
    _, out = setup
    n = shape[1]
    for got in _each(out, shape):
        np.testing.assert_array_equal(got["a2a"], jref["a2a"])
        np.testing.assert_array_equal(got["a2a_oor"], jref["a2a_oor"])
        assert not got["a2a_oor"][[1, 3, 5, 7]].any()
        np.testing.assert_array_equal(got["a2a_skew"], jref["a2a_skew"])
        assert got["a2a_skew_overflow"] == jref["a2a_skew_overflow"] == 0
        np.testing.assert_array_equal(got["a2a_cap"], jref[f"a2a_cap{n}"])
        assert got["a2a_cap_overflow"] == jref[f"a2a_cap_overflow{n}"] > 0
        # one all-to-all out (ids), one back (rows); nothing else
        counts = got["a2a_counts"]
        assert counts["all_to_all"] == 2
        assert counts["all_gather"] == counts["all_reduce"] == 0


@pytest.mark.parametrize("shape", SPARSE_MESHES)
def test_alltoall_gradient_and_push_match_jax(setup, jref, shape):
    _, out = setup
    for got in _each(out, shape):
        np.testing.assert_allclose(got["a2a_grad"], jref["a2a_grad"], **SUM)
        np.testing.assert_allclose(got["push"], jref["push"], **SUM)


@pytest.mark.parametrize("shape", SPARSE_MESHES)
def test_sharded_embedding_end_to_end_matches_jax(setup, jref, shape):
    payload, out = setup
    untouched = [i for i in range(30) if i not in (1, 7, 19)]
    for got in _each(out, shape):
        assert got["e2e_padded"] == -(-30 // shape[1]) * shape[1]
        np.testing.assert_allclose(got["e2e_losses"], jref["e2e_losses"],
                                   rtol=1e-5)
        assert got["e2e_losses"][-1] < got["e2e_losses"][0] * 0.5
        # the same table rows (the padding differs by the axis size)
        np.testing.assert_allclose(got["e2e_table"][:30],
                                   jref["e2e_table"][:30], **SUM)
        np.testing.assert_array_equal(got["e2e_table"][untouched],
                                      payload["e2e_table"][untouched])


def test_unique_rows_grad_and_overflow_match_jax():
    ids = np.asarray([4, 4, 9, 4])
    grads = np.ones((4, 3), np.float32)
    ju, js = JS.unique_rows_grad(jnp.asarray(ids), jnp.asarray(grads),
                                 max_unique=4)
    tu, ts = TS.unique_rows_grad(torch.from_numpy(ids),
                                 torch.from_numpy(grads), max_unique=4)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SUM)
    ids = np.asarray([1, 2, 3, 4, 1])
    for bound in (2, 4):
        _, _, jov = JS.unique_rows_grad(jnp.asarray(ids), jnp.ones((5, 2)),
                                        max_unique=bound,
                                        return_overflow=True)
        _, _, tov = TS.unique_rows_grad(torch.from_numpy(ids),
                                        torch.ones((5, 2)),
                                        max_unique=bound,
                                        return_overflow=True)
        assert int(tov) == int(jov)


def test_embedding_ops_match_jax():
    table = _table(12, 5)
    ids = np.random.RandomState(0).randint(0, 12, (3, 4))
    tt, ti = torch.from_numpy(table), torch.from_numpy(ids)
    np.testing.assert_array_equal(
        TE.embedding_lookup(tt, ti).numpy(),
        np.asarray(JE.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))))
    np.testing.assert_allclose(
        TE.one_hot_matmul_lookup(tt, ti).numpy(),
        np.asarray(JE.one_hot_matmul_lookup(jnp.asarray(table),
                                            jnp.asarray(ids))), **SUM)
    flat, seg = np.asarray([0, 3, 3, 9, 11]), np.asarray([0, 0, 1, 1, 2])
    for comb in ("sum", "mean", "sqrtn"):
        np.testing.assert_allclose(
            TE.embedding_bag(tt, torch.from_numpy(flat),
                             torch.from_numpy(seg), 3,
                             combiner=comb).numpy(),
            np.asarray(JE.embedding_bag(jnp.asarray(table),
                                        jnp.asarray(flat), jnp.asarray(seg),
                                        3, combiner=comb)), **SUM)
    with pytest.raises(ValueError, match="combiner"):
        TE.embedding_bag(tt, torch.from_numpy(flat), torch.from_numpy(seg),
                         3, combiner="bogus")


class TestHostOffloadEmbedding:
    """JAX's HostOffloadEmbedding tests (tests/test_sparse_parallel.py
    TestHostOffloadEmbedding), each against the live JAX class on the
    same table: rows exact, updates within 1e-6."""

    def _pair(self, vocab=32, dim=4):
        jemb = JS.HostOffloadEmbedding(vocab, dim, init_scale=0.1)
        jt = jemb.init(jax.random.key(0))
        temb = TS.HostOffloadEmbedding(vocab, dim, init_scale=0.1,
                                       device="cpu")
        tt = temb.place(torch.from_numpy(np.asarray(jax.device_get(jt))))
        return jemb, jt, temb, tt

    def test_table_lives_in_host_memory(self):
        _, _, temb, tt = self._pair()
        assert tt.device.type == "cpu" and tt.is_contiguous()
        assert temb.n_shards == 1 and temb.shard_failovers() == [0]
        assert temb.poll_watermarks(tt) is None
        np.testing.assert_array_equal(temb.owner_of([3, -1, 31, 32]),
                                      [0, -1, 0, -1])

    def test_lookup_matches_jax(self):
        jemb, jt, temb, tt = self._pair()
        ids = np.asarray([3, 7, 3, 31, -1, 40])
        want = np.asarray(jax.jit(jemb.lookup)(jt, jnp.asarray(ids)))
        got = temb.lookup(tt, torch.from_numpy(ids))
        np.testing.assert_array_equal(got.numpy(), want)
        rows, marks = temb.pull_rows(tt, ids)
        assert marks is None and rows.dtype == np.float32
        np.testing.assert_array_equal(rows, want)
        got, ov = temb.alltoall_lookup(tt, torch.from_numpy(ids),
                                       return_overflow=True)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(ov) == 0

    def test_row_sparse_update_matches_jax(self):
        jemb, jt, temb, tt = self._pair()
        before = tt.clone()
        ids = np.asarray([2, 2, 5, -1])
        grads = np.ones((4, 4), np.float32)
        want = np.asarray(jax.device_get(jemb.update(
            jt, jnp.asarray(ids), jnp.asarray(grads),
            jnp.asarray(0.5, jnp.float32))))
        got = temb.update(tt, torch.from_numpy(ids),
                          torch.from_numpy(grads), 0.5)
        assert got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, **SUM)
        untouched = [i for i in range(32) if i not in (2, 5)]
        np.testing.assert_array_equal(got.numpy()[untouched],
                                      before.numpy()[untouched])

    def test_train_step_end_to_end_matches_jax(self):
        jemb, jt, temb, tt = self._pair(16, 3)
        ids = np.asarray([1, 4, 9])
        target = jnp.ones((3, 3), jnp.float32)
        jl, tl = [], []

        @jax.jit
        def jgrads(table):
            rows = jemb.lookup(table, jnp.asarray(ids))
            return jax.value_and_grad(
                lambda r: jnp.mean((r - target) ** 2))(rows)

        for _ in range(40):
            loss, rg = jgrads(jt)
            jt = jemb.update(jt, jnp.asarray(ids), rg,
                             jnp.asarray(1.0, jnp.float32))
            jl.append(float(loss))
            rows = temb.lookup(tt, torch.from_numpy(ids)) \
                .requires_grad_()
            loss = torch.mean((rows - 1.0) ** 2)
            (g,) = torch.autograd.grad(loss, [rows])
            temb.apply_row_grads(tt, torch.from_numpy(ids), g, 1.0)
            tl.append(float(loss))
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-7)
        assert tl[-1] < tl[0] * 0.2
        np.testing.assert_allclose(tt.numpy(),
                                   np.asarray(jax.device_get(jt)),
                                   rtol=1e-5, atol=1e-6)
