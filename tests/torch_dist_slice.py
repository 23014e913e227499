"""Rank-side cases of the sparse-embedding, CTR, blocked-matmul, TP
engine-pool and elastic parity tests (tests/test_torch_sparse.py,
_ctr, _blocked_matmul, _engine_tp, _elastic), run by
`torch_dist.run_group(world, "torch_dist_slice:<case>", payload, tmp)`.
Like `torch_dist`, this module imports no jax: the children import it,
the test modules compare what it returns with the JAX package."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_dist import _t, full_tree


@pytest.fixture(autouse=True)
def no_process_group_left():
    """A test that builds a mesh in the pytest process starts a
    world-size-1 process group there; end it with the test, since a later
    file on the same worker may test the process bootstrap (a module
    importing this fixture uses it on each of its tests)."""
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(data, model, ranks, seq=1):
    from paddle_tpu_torch.core import mesh as M

    return M.build_mesh(M.MeshConfig(data, model, seq), device="cpu",
                        ranks=list(ranks))


def _full(x):
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().cpu().numpy().copy()


def _err(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


# ---- test_torch_sparse.py ----

#: (data, model) meshes: 2 and 4 ranks on the model axis, and 2 x 2
SPARSE_MESHES = [(1, 2), (1, 4), (2, 2)]


def sparse_cases(rank, world, payload):
    from paddle_tpu_torch.parallel import sparse as SP

    res = {}
    for data, model in SPARSE_MESHES:
        mesh = _mesh(data, model, range(data * model))
        if not mesh.contains_me:
            continue
        out = res[(data, model)] = {}
        table = _t(payload["table"])
        sh = lambda t=table: SP.shard_rows(t, mesh)
        out["lookup"] = _full(SP.sharded_lookup(sh(), _t(payload["ids57"]),
                                                mesh))
        t = sh().detach().requires_grad_()
        y = SP.sharded_lookup(t, _t(payload["gids"]), mesh)
        (g,) = torch.autograd.grad(torch.sum(y * _t(payload["cot"])), [t])
        out["lookup_grad"] = _full(g)
        for comb in ("sum", "mean", "sqrtn"):
            out[f"bag_{comb}"] = _full(SP.sharded_embedding_bag(
                sh(), _t(payload["bag_ids"]), _t(payload["bag_seg"]), 2,
                mesh, combiner=comb))
        out["bag_bogus"] = _err(lambda: SP.sharded_embedding_bag(
            sh(), _t(payload["bag_ids"]), _t(payload["bag_seg"]), 2, mesh,
            combiner="bogus"))
        out["rowwise"] = _full(SP.rowwise_sgd_update(
            sh(), _t(payload["rw_ids"]), _t(payload["rw_grads"]), 0.1, mesh))
        out["not_divisible"] = _err(lambda: SP.shard_rows(
            _t(payload["table31"]), mesh))
        out["a2a"] = _full(SP.alltoall_lookup(sh(), _t(payload["ids24"]),
                                              mesh))
        out["a2a_oor"] = _full(SP.alltoall_lookup(sh(),
                                                  _t(payload["oor"]), mesh))
        got, ov = SP.alltoall_lookup(sh(), _t(payload["skew"]), mesh,
                                     return_overflow=True)
        out["a2a_skew"], out["a2a_skew_overflow"] = _full(got), int(ov)
        got, ov = SP.alltoall_lookup(sh(), _t(payload["zeros16"]), mesh,
                                     capacity=1, return_overflow=True)
        out["a2a_cap"], out["a2a_cap_overflow"] = _full(got), int(ov)
        t16 = SP.shard_rows(_t(payload["table16"]), mesh)
        t16 = t16.detach().requires_grad_()
        y = SP.alltoall_lookup(t16, _t(payload["g_ids"]), mesh)
        # the ids' split is the rows': each rank's loss term uses its
        # own rows, and the global loss is their sum
        w = _t(payload["g_w"])
        n = mesh.shape["model"]
        i = mesh.axis_index("model")
        k = w.shape[0] // n
        (g,) = torch.autograd.grad(
            torch.sum(y.to_local() * w[i * k:(i + 1) * k]), [t16])
        out["a2a_grad"] = _full(g)
        out["push"] = _full(SP.alltoall_push_row_grads(
            SP.shard_rows(_t(payload["table32x6"]), mesh),
            _t(payload["push_ids"]), _t(payload["push_grads"]), 0.3, mesh))
        from paddle_tpu_torch.parallel import collectives as C

        C.reset_launch_counts()
        SP.alltoall_lookup(sh(), _t(payload["ids24"]), mesh)
        out["a2a_counts"] = dict(C.launch_counts)
        # the module end to end: loss falls, untouched rows stay put
        emb = SP.ShardedEmbedding(vocab=30, dim=4, mesh=mesh, init_scale=0.1)
        et = emb.place(_t(payload["e2e_table"]))
        ids = _t(payload["e2e_ids"])
        target = _t(payload["e2e_target"])
        losses = []
        for _ in range(20):
            rows = emb.lookup(et, ids).detach().requires_grad_()
            loss = torch.mean((rows - target) ** 2)
            (rg,) = torch.autograd.grad(loss, [rows])
            losses.append(float(loss))
            emb.apply_row_grads(et, ids, rg, 0.5)
        out["e2e_losses"] = losses
        out["e2e_table"] = _full(et)
        out["e2e_padded"] = emb.padded_vocab
    return res


# ---- test_torch_ctr.py ----

CTR_MESHES = [(1, 2), (1, 4), (2, 2)]


def ctr_cases(rank, world, payload):
    from paddle_tpu_torch.models.ctr import CTRModel
    from paddle_tpu_torch.models.weights import params_from_numpy
    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.parallel import collectives as C

    res = {}
    for data, model in CTR_MESHES:
        mesh = _mesh(data, model, range(data * model))
        if not mesh.contains_me:
            continue
        out = res[(data, model)] = {}
        for ex in ("alltoall", "psum"):
            m = CTRModel(vocab=payload["vocab"], embed_dim=8, mesh=mesh,
                         hidden=(16,), exchange=ex)
            params = m.place(params_from_numpy(payload["params"][model],
                                               device="cpu"))
            opt = O.adam(1e-2)
            opt_state = opt.init(params["mlp"])
            step = m.make_train_step(opt, {})
            losses = []
            C.reset_launch_counts()
            for i in range(3):
                params, opt_state, loss = step(
                    params, opt_state, _t(payload["ids"]),
                    _t(payload["labels"]), 0.1,
                    torch.tensor(i, dtype=torch.int32))
                losses.append(float(loss))
            out[ex] = {"losses": losses, "params": full_tree(params),
                       "counts": dict(C.launch_counts)}
    return res


# ---- test_torch_blocked_matmul.py ----


def blocked_cases(rank, world, payload):
    from paddle_tpu_torch.core import mesh as M
    from paddle_tpu_torch.parallel import blocked_matmul as BM
    from paddle_tpu_torch.parallel import collectives as C

    res = {}
    for p in (2, 4):
        mesh = M.make_mesh((p,), ("x",), "cpu", ranks=list(range(p)))
        if not mesh.contains_me:
            continue
        out = res[p] = {}
        for name, case in payload.items():
            if name == "grad" or case["p"] != p:
                continue
            dt = getattr(torch, case["dtype"])
            x, w = _t(case["x"]).to(dt), _t(case["w"]).to(dt)
            kind = case["kind"]
            with torch.no_grad():
                if kind in ("gather", "reduce"):
                    got = BM.collective_matmul(
                        mesh, axis="x", mode=kind,
                        overlap=case["overlap"])(x, w)
                elif kind == "stream":
                    got = BM.blocked_matmul(mesh, axis="x")(x, w)
                else:
                    w_loc = C.shard_local(w, ("x", None), mesh=mesh)
                    got = BM.tp_dense(x, w_loc, axis="x",
                                      overlap=case["overlap"], mesh=mesh)
            out[name] = {"out": _full(got.float()),
                         "dtype": str(got.dtype).replace("torch.", "")}
        out["reduce_untileable"] = _err(lambda: BM.collective_matmul(
            mesh, axis="x", mode="reduce")(_t(np.ones((5, 8), np.float32)),
                                           _t(np.ones((8, 4), np.float32))))
        out["bad_mode"] = _err(lambda: BM.collective_matmul(
            mesh, axis="x", mode="scatter"))
        # gradients through the rings (autograd's differentiable shift)
        xg, wg = _t(payload["grad"]["x"]), _t(payload["grad"]["w"])
        grads = {}
        for mode in ("gather", "reduce"):
            xl = xg.clone().requires_grad_()
            wl = wg.clone().requires_grad_()
            y = BM.collective_matmul(mesh, axis="x", mode=mode)(xl, wl)
            loss = torch.sum(y.full_tensor() ** 2)
            grads[mode] = [g.numpy() for g in
                           torch.autograd.grad(loss, [xl, wl])]
        out["grads"] = grads
    return res


# ---- test_torch_engine_tp.py ----


def engine_tp_cases(rank, world, payload):
    """The DecodeEngine pool over TP_RULES parameters at TP = 2 (ranks
    [0, 1]) and TP = 4, float and int8 KV: tokens, the arenas' placement
    and the heads each rank's walk saw; and B's and C's rules called
    directly on random arenas against the plain walk on the full heads,
    with a placement they do not take refused."""
    import dataclasses

    from torch.distributed.tensor import DTensor, Replicate, Shard

    from paddle_tpu_torch.core import mesh as M
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.models.weights import params_from_numpy
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.ops import ragged_paged_attention as RPA
    from paddle_tpu_torch.parallel import sharding as S
    from paddle_tpu_torch.serve.engine import DecodeEngine

    cfg0 = T.TransformerConfig(**payload["cfg"])
    prompts = [np.asarray(p, np.int32) for p in payload["prompts"]]
    seen = []
    plain = RPA.ragged_reference

    def spy(q, *a, **k):
        seen.append(int(q.shape[2]))
        return plain(q, *a, **k)

    RPA.ragged_reference = spy
    res = {}
    for tp in (2, 4):
        mesh = M.build_mesh(M.MeshConfig(1, tp), "cpu", ranks=range(tp))
        if not mesh.contains_me:
            continue
        out = res[tp] = {}
        params = params_from_numpy(payload["params"], device="cpu")
        sharded = S.place(params, S.make_param_shardings(params, mesh,
                                                         T.TP_RULES))
        for kv in ("compute", "int8"):
            cfg = dataclasses.replace(cfg0, kv_cache_dtype=kv)
            eng = DecodeEngine(sharded, cfg, slots=2, max_len=24,
                               page_size=4, device="cpu")
            seen.clear()
            got = eng.serve(prompts, max_new=5)
            arena = eng.init_state().caches[0][0]
            arena = arena[0] if kv == "int8" else arena
            out[kv] = {"tokens": [list(map(int, t)) for t in got],
                       "walk_heads": sorted(set(seen)),
                       "walks": len(seen),
                       "placements": str(arena.placements),
                       "local_heads": int(arena.to_local().shape[2]),
                       "geometry_heads": eng.kv_geometry()["kv_heads"]}
        # the rules on random arenas: each rank's heads walked alone,
        # equal to the plain walk of all heads
        r = np.random.RandomState(5)
        h, dh, pages, page = 4, 8, 6, 4
        q = _t(r.randn(2, 3, h, dh).astype(np.float32))
        kf = _t(r.randn(pages, page, h, dh).astype(np.float32))
        vf = _t(r.randn(pages, page, h, dh).astype(np.float32))
        table = torch.tensor([[0, 2, 4], [1, 3, 5]], dtype=torch.int32)
        pos0 = torch.tensor([3, 6], dtype=torch.int32)
        active = torch.tensor([True, True])
        heads = [Shard(2)]
        dt = lambda t: DTensor.from_local(
            t.chunk(tp, 2)[mesh.axis_index("model")].contiguous(),
            mesh.dtensor_mesh, heads, run_check=False, shape=t.shape,
            stride=t.stride())
        kw = dict(page_size=page, max_len=12)
        walks = {}
        for kind in ("float", "int8"):
            if kind == "int8":
                ka, va = PA.kv_quantize(kf), PA.kv_quantize(vf)
                k_dt = tuple(dt(t) for t in ka)
                v_dt = tuple(dt(t) for t in va)
            else:
                ka, va, k_dt, v_dt = kf, vf, dt(kf), dt(vf)
            want = plain(q, ka, va, table, pos0, active, **kw)
            got = RPA.ragged_attention(dt(q), k_dt, v_dt, table, pos0,
                                       active, **kw)
            walks[kind] = float((got.full_tensor() - want).abs().max())
        out["rule_err"] = walks
        rows = DTensor.from_local(kf, mesh.dtensor_mesh, [Replicate()],
                                  run_check=False).redistribute(
            mesh.dtensor_mesh, [Shard(0)])
        out["refused"] = _err(lambda: RPA.ragged_attention(
            dt(q), rows, rows, table, pos0, active, **kw))
    RPA.ragged_reference = plain
    return res


# ---- test_torch_elastic.py ----


def _zero_model(hidden=7, out=3):
    from paddle_tpu_torch.nn.layers import Dense
    from paddle_tpu_torch.nn.module import Sequential

    return Sequential([Dense(hidden, name="fc", activation="relu"),
                       Dense(out, name="out")])


def mse(out, y):
    return torch.mean((out - y) ** 2)


def _zero_state(model, opt, mesh):
    from paddle_tpu_torch.nn.module import ShapeSpec
    from paddle_tpu_torch.train.state import TrainState

    params, mstate = model.init(0, ShapeSpec((8, 8)), device="cpu")
    return TrainState.create_zero(params, mstate, opt, mesh)


def _advance(model, opt, mesh, state, payload, steps=2):
    from paddle_tpu_torch.parallel import train_step as TS

    step = TS.make_zero_train_step(model, mse, opt, mesh, donate=False)
    x, y = _t(payload["x"]), _t(payload["y"])
    loss = None
    for _ in range(steps):
        state, loss, _ = step(state, None, x, y)
    return state, step, float(loss)


def _unpadded(params, opt):
    """The unpadded prefix of every flat ZeRO moment, in JAX's flatten
    order."""
    from paddle_tpu_torch.core.pytree import flatten_with_keys
    from paddle_tpu_torch.parallel.train_step import zero_true_sizes

    sizes = [t for _, t in flatten_with_keys(zero_true_sizes(params, opt))]
    full = full_tree(opt)
    leaves = [v for _, v in flatten_with_keys(full)]
    return [np.asarray(v).reshape(-1)[:t] for t, v in zip(sizes, leaves)]


def elastic_cases(rank, world, payload):
    """ZeRO states saved through the ElasticCheckpointManager at 4 ranks
    and restored at 2 (ranks [0, 1]) and 1 (rank 0), adam and an uneven
    Dense(5) net; the 1 -> 4 direction and one more step on each side;
    a ResilientTrainer at 4 ranks handing its run to one at 2."""
    import json
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.train.checkpoint import ElasticCheckpointManager
    from paddle_tpu_torch.train.resilience import ResilientTrainer
    from paddle_tpu_torch.train.trainer import Trainer

    root = payload["dir"]
    meshes = {m: _mesh(m, 1, range(m)) for m in (4, 2, 1)}
    out = {}
    for name, hidden in (("adam", 7), ("uneven", 5)):
        model, opt = _zero_model(hidden), O.adam(1e-2)
        d = os.path.join(root, name)
        st4 = _zero_state(model, opt, meshes[4])
        st4, _, _ = _advance(model, opt, meshes[4], st4, payload)
        ElasticCheckpointManager(d, mesh=meshes[4]).save(st4)
        saved = {"params": full_tree(st4.params), "step": int(st4.step),
                 "opt": _unpadded(st4.params, st4.opt_state)}
        if rank == 0:
            with open(os.path.join(d, f"zero_topology_{int(st4.step)}"
                                   ".json")) as f:
                saved["manifest"] = json.load(f)
        for m in (2, 1):
            mesh = meshes[m]
            if not mesh.contains_me:
                continue
            mgr = ElasticCheckpointManager(d, mesh=mesh)
            got = mgr.restore(_zero_state(model, opt, mesh))
            saved[m] = {"params": full_tree(got.params),
                        "step": int(got.step),
                        "opt": _unpadded(got.params, got.opt_state),
                        "reshards": mgr.reshard_restores}
        out[name] = saved
    # 1 -> 4 and one more step on each topology
    model, opt = _zero_model(), O.momentum(0.05, 0.9)
    d = os.path.join(root, "up")
    if meshes[1].contains_me:
        st1 = _zero_state(model, opt, meshes[1])
        st1, step1, _ = _advance(model, opt, meshes[1], st1, payload)
        ElasticCheckpointManager(d, mesh=meshes[1]).save(st1)
        _, l1, _ = step1(st1, None, _t(payload["x"]), _t(payload["y"]))
        out["up_l1"] = float(l1)
        out["up_opt1"] = _unpadded(st1.params, st1.opt_state)
    dist.barrier()
    mgr = ElasticCheckpointManager(d, mesh=meshes[4])
    st4 = mgr.restore(_zero_state(model, opt, meshes[4]))
    out["up_opt4"] = _unpadded(st4.params, st4.opt_state)
    out["up_reshards"] = mgr.reshard_restores
    _, _, out["up_l4"] = _advance(model, opt, meshes[4], st4, payload, 1)
    # a ResilientTrainer's run handed from 4 ranks to 2
    ckpt = os.path.join(root, "rt")

    def make_rt(mesh, gang_epoch):
        from paddle_tpu_torch.parallel.train_step import make_zero_train_step

        model, opt = _zero_model(), O.momentum(0.05, 0.9)
        trainer = Trainer(model, mse, opt, seed=0, device="cpu")
        state = _zero_state(model, opt, mesh)
        rt = ResilientTrainer(
            trainer, ckpt,
            checkpoint_manager=ElasticCheckpointManager(ckpt, mesh=mesh),
            checkpoint_every_n_batches=2, install_signal_handlers=False,
            step_builder=lambda o: make_zero_train_step(
                model, mse, o, mesh, donate=False),
            gang_epoch=gang_epoch)
        return rt, state

    def factory_for(total):
        def factory():
            rng = np.random.RandomState(5)
            for _ in range(total):
                yield (_t(rng.randn(8, 8).astype(np.float32)),
                       _t(rng.randn(8, 3).astype(np.float32)))
        return factory

    rt4, s4 = make_rt(meshes[4], 0)
    out["rt4_step"] = int(rt4.run(s4, factory_for(4), num_passes=1).step)
    dist.barrier()
    if meshes[2].contains_me:
        rt2, s2 = make_rt(meshes[2], 1)
        final = rt2.run(s2, factory_for(8), num_passes=1)
        out["rt2"] = {"restored": rt2.restored_step,
                      "step": int(final.step),
                      "counters": rt2.counters()}
    return out
