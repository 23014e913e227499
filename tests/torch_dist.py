"""Rank-side cases of the distributed parity tests
(tests/test_torch_mesh.py, _sharded_step, _zero, _ring_attention,
_pipeline, _moe_ep, _dryrun).

`run_group` spawns one gloo process group on the CPU (a `file://`
rendezvous under the test's tmp dir, no TCP port) and runs one named
case function of this module ("name", or "module:name" elsewhere) on
every rank; each rank's return value
(numpy arrays, python values) comes back to the parent, which compares
them with the JAX package. This module imports no jax: a spawned child
imports the module that defines its target, and the test modules import
JAX.

A case takes (rank, world, payload) and returns a picklable value. Every
rank runs every mesh construction of a case (a mesh is built by all
ranks of the job), but only the ranks a mesh holds compute on it, so a
world of 4 also holds the cases of 2-rank meshes.
"""

from __future__ import annotations

import importlib
import os
import pickle
import time
import traceback

import numpy as np
import torch


def run_group(world: int, case: str, payload, tmp_path, *,
              timeout: float = 240.0):
    """Run `case` on `world` spawned gloo ranks; returns [result of rank
    r]. A rank that fails or a group that outlives `timeout` fails the
    call (the children are killed)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = os.path.join(str(tmp_path), f"group_{case.rpartition(':')[2]}")
    os.makedirs(out, exist_ok=True)
    rdv = os.path.join(out, "rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    procs = [ctx.Process(target=_child,
                         args=(r, world, rdv, out, case, payload))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    results, errors = [], []
    for r in range(world):
        path = os.path.join(out, f"{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit {procs[r].exitcode})")
            results.append(None)
            continue
        with open(path, "rb") as f:
            ok, value = pickle.load(f)
        if not ok:
            errors.append(f"rank {r}:\n{value}")
        results.append(value)
    if alive:
        errors.append(f"{len(alive)} rank(s) killed after {timeout} s")
    if errors:
        raise AssertionError("\n".join(errors))
    return results


def _child(rank, world, rdv, out, case, payload):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        mod, _, name = case.rpartition(":")
        fn = getattr(importlib.import_module(mod or __name__), name)
        result = (True, fn(rank, world, payload))
    except BaseException:
        result = (False, traceback.format_exc())
    with open(os.path.join(out, f"{rank}.pkl.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(out, f"{rank}.pkl.tmp"),
               os.path.join(out, f"{rank}.pkl"))
    if result[0]:
        dist.barrier()
    dist.destroy_process_group()
    os._exit(0)


# ---- helpers ----


def np_tree(tree):
    """A tree of tensors (DTensors: their LOCAL shard) as numpy."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [np_tree(v) for v in tree]
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def full_tree(tree):
    """A tree of DTensors gathered to full numpy values."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [full_tree(v) for v in tree]
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def _mesh(shape, **kw):
    from paddle_tpu_torch.core import mesh as M

    n = int(np.prod(shape))
    return M.build_mesh(M.MeshConfig(*shape), device="cpu",
                        ranks=list(range(n)), **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


MESH_SHAPES = [(2, 1, 1), (2, 2, 1), (1, 2, 1), (1, 1, 2), (1, 1, 4),
               (4, 1, 1)]


# ---- test_torch_mesh.py ----


def mesh_cases(rank, world, payload):
    from paddle_tpu_torch.parallel import collectives as C
    from paddle_tpu_torch.parallel import distributed as D

    res = {"count": D.process_count(), "index": D.process_index(),
           "primary": D.is_primary()}
    D.sync_hosts("start")
    x = torch.full((3,), float(rank))
    res["bcast"] = D.broadcast_from_primary(
        {"t": x, "host": f"from {rank}"})
    res["bcast"]["t"] = res["bcast"]["t"].numpy()
    res["agree_same"] = D.replicated_agree(np.arange(3))
    res["agree_diff"] = D.replicated_agree(x)
    res["coords"], res["coll"] = {}, {}
    data = payload["x"]
    for shape in MESH_SHAPES:
        mesh = _mesh(shape)
        if not mesh.contains_me:
            continue
        res["coords"][shape] = tuple(mesh.axis_index(a)
                                     for a in mesh.axis_names)
        out = {}
        for axis in ("data", "model", "seq"):
            n = mesh.shape[axis]
            if n == 1:
                continue
            i = C.axis_index(axis, mesh)
            # this rank's block of the [n*4, 6] input, as a JAX shard_map
            # over P(axis) hands it out
            loc = _t(data[:n * 4]).reshape(n, 4, 6)[i].requires_grad_()
            with mesh:
                outs = {
                    "psum": C.all_reduce_sum(loc, axis),
                    "pmean": C.all_reduce_mean(loc, axis),
                    "gather": C.all_gather(loc, axis),
                    "gather_d1": C.all_gather(loc, axis, dim=1),
                    "scatter": C.reduce_scatter(loc, axis),
                    "a2a": C.all_to_all(loc.reshape(4, 6), axis,
                                        split_axis=0, concat_axis=1),
                    "ring": C.ppermute_ring(loc, axis),
                    "ring_back": C.ppermute_ring(loc, axis, shift=-1),
                }
            got = {k: v.detach().numpy() for k, v in outs.items()}
            grads = {}
            for k, v in outs.items():
                # psum/pmean outputs are one replicated value: one
                # cotangent; the others each rank's own
                src = payload["cot"][0 if k in ("psum", "pmean") else rank]
                cot = _t(src[:v.numel()]).reshape(v.shape)
                (g,) = torch.autograd.grad(v, loc, cot)
                grads[k] = g.numpy()
            out[axis] = {"index": i, "out": got, "grad": grads}
        res["coll"][shape] = out
        # the whole-array forms over the first axis larger than 1
        axis = next((a for a in mesh.axis_names if mesh.shape[a] > 1), None)
        if axis is not None:
            n = mesh.shape[axis]
            arr = _t(data[:n * 2])
            red = C.device_all_reduce_mean(arr, mesh, axis)
            bc = C.device_broadcast_from(arr, mesh, axis, source=n - 1)
            res["coll"][shape]["whole"] = {
                "axis": axis, "mean": red.to_local().numpy(),
                "bcast": bc.to_local().numpy(),
                "repl": C.replicate(arr, mesh).to_local().numpy()}
    return res


# ---- test_torch_sharded_step.py ----

LM_KW = dict(vocab=64, dim=16, n_layers=2, n_heads=2, n_kv_heads=1)
MOE_KW = dict(vocab=64, dim=16, n_layers=2, n_heads=2, moe_experts=4,
              moe_every=2)
MLP_RULES = [("fc1/kernel", ("__P__", None, "model")),
             ("fc2/kernel", ("__P__", "model", None))]


def _rules(rules):
    from paddle_tpu_torch.core.mesh import P

    return [(pat, P(*spec[1:]) if isinstance(spec, tuple)
             and spec[:1] == ("__P__",) else spec) for pat, spec in rules]


def mlp_model():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import layers as L

    return nn.module.Sequential([
        L.Dense(32, name="fc1", activation="relu"),
        L.Dense(32, name="fc2", activation="relu"),
        L.Dense(8, name="logits")])


def mlp_loss(logits, labels):
    from paddle_tpu_torch.ops import losses

    return torch.mean(losses.softmax_cross_entropy(logits, labels))


def _count_flash_plain():
    from paddle_tpu_torch.ops import flash_attention as FA

    calls = [0]
    orig = FA.flash_attention_reference

    def counted(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    FA.flash_attention_reference = counted
    return calls


def sharded_cases(rank, world, payload):
    from paddle_tpu_torch.core.mesh import P
    from paddle_tpu_torch.graft_entry import LMLoss, identity_loss
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.models.weights import params_from_numpy
    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.parallel import sharding as S
    from paddle_tpu_torch.parallel import train_step as TS
    from paddle_tpu_torch.train.state import TrainState

    cpu = dict(device="cpu")
    lm = params_from_numpy(payload["lm"], **cpu)
    moe_lm = params_from_numpy(payload["moe_lm"], **cpu)
    mlp = params_from_numpy(payload["mlp"], **cpu)
    res = {"place": {}}
    for shape in MESH_SHAPES:
        mesh = _mesh(shape)
        if not mesh.contains_me:
            continue
        trees = {
            "tp": (lm, T.TP_RULES),
            "tp_moe": (moe_lm, T.TP_MOE_RULES),
            "megatron": ({**mlp, "emb": {"table": _t(payload["table"])}},
                         S.MEGATRON_RULES),
            "fit": ({"odd": _t(payload["odd"]), "even": _t(payload["even"])},
                    [(r"odd|even", P("data", "model"))]),
        }
        got = {k: np_tree(S.place(t, S.make_param_shardings(t, mesh, r)))
               for k, (t, r) in trees.items()}
        adam = O.adam(1e-3).init(mlp)
        got["zero"] = np_tree(S.place(adam, S.zero_shardings(adam, mesh)))
        res["place"][shape] = got

    x, y = _t(payload["x"]), _t(payload["y"])
    # dp: 3 steps of the MLP over (2, 1, 1)
    mesh = _mesh((2, 1, 1))
    if mesh.contains_me:
        opt = O.adam(1e-3)
        state = TS.shard_train_state(TrainState.create(
            params_from_numpy(payload["mlp"], **cpu), {}, opt), mesh)
        step = TS.make_sharded_train_step(mlp_model(), mlp_loss, opt, mesh)
        losses = []
        for _ in range(3):
            state, loss, _ = step(state, None, (x,), (y,))
            losses.append(float(loss))
        res["dp"] = {"losses": losses, "params": full_tree(state.params)}
    # dp x tp, ZeRO placement, two microbatches: the dryrun's step
    mesh = _mesh((2, 2, 1))
    if mesh.contains_me:
        opt = O.adam(1e-3)
        rules = _rules(MLP_RULES)
        state = TS.shard_train_state(TrainState.create(
            params_from_numpy(payload["mlp"], **cpu), {}, opt), mesh,
            param_rules=rules, zero=True)
        step = TS.make_sharded_train_step(
            mlp_model(), mlp_loss, opt, mesh, param_rules=rules, zero=True,
            accum_steps=2)
        losses = []
        for _ in range(2):
            state, loss, _ = step(state, None, (x,), (y,))
            losses.append(float(loss))
        res["dptp"] = {"losses": losses, "params": full_tree(state.params),
                       "local": np_tree(state.params),
                       "opt_local": np_tree(state.opt_state)}
    # the LM under TP_RULES on (2, 2, 1), kernel A's plain version
    # through its DTensor rule
    if mesh.contains_me:
        cfg = T.TransformerConfig(**LM_KW, attn_impl="flash")
        opt = O.adam(1e-3)
        state = TS.shard_train_state(TrainState.create(
            params_from_numpy(payload["lm"], **cpu), {}, opt), mesh,
            param_rules=T.TP_RULES)
        step = TS.make_sharded_train_step(LMLoss(cfg), identity_loss, opt,
                                          mesh, param_rules=T.TP_RULES)
        calls = _count_flash_plain()
        toks = _t(payload["tokens"])
        losses = []
        for _ in range(2):
            state, loss, _ = step(state, None, (toks,), ())
            losses.append(float(loss))
        res["lm_tp"] = {"losses": losses, "params": full_tree(state.params),
                        "local": np_tree(state.params),
                        "flash_plain_calls": calls[0]}
        # tensor-parallel greedy decode on the TP-sharded parameters
        params = S.place(lm, S.make_param_shardings(lm, mesh, T.TP_RULES))
        prompt = _t(payload["prompt"])
        calls[0] = 0
        out = T.generate(params, cfg, S.place(
            prompt, S.batch_sharding(mesh)), steps=4)
        res["tp_generate"] = {"tokens": full_tree(out),
                              "flash_plain_calls": calls[0],
                              "plain": T.generate(lm, cfg, prompt,
                                                  steps=4).numpy()}
    res["conv_dp"] = conv_dp_case(rank)
    return res


def conv_net():
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.nn import module as NM

    return NM.Sequential([
        L.Conv2D(8, 3, stride=2, padding="SAME", use_bias=False, name="c1"),
        L.BatchNorm(activation="relu", name="bn1"),
        L.MaxPool2D(2, name="mp"),
        L.Conv2D(8, 3, padding="SAME", name="c2"),
        L.GlobalAvgPool2D(name="pool"), L.Dense(4, name="fc")])


def conv_dp_case(rank):
    """A conv + BN net data-parallel over (2, 1, 1), float64, 2
    momentum steps, beside the single-process step on the whole batch
    (rank 0 runs both; rank 1 its half of the sharded one)."""
    from paddle_tpu_torch.core import dtypes
    from paddle_tpu_torch.nn.module import ShapeSpec
    from paddle_tpu_torch.ops import losses
    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.parallel import train_step as TS
    from paddle_tpu_torch.train.state import TrainState
    from paddle_tpu_torch.train.trainer import make_train_step

    f64 = torch.float64
    mesh = _mesh((2, 1, 1))
    if not mesh.contains_me:
        return None
    prev = dtypes.default_policy()
    dtypes.set_default_policy(dtypes.Policy(f64, f64, f64))
    try:
        model = conv_net()
        params, mstate = model.init(0, ShapeSpec((8, 12, 12, 3)),
                                    device="cpu")
        cast = lambda t: t.to(f64) if t.is_floating_point() else t
        from paddle_tpu_torch.core.pytree import tree_map
        params, mstate = tree_map(cast, params), tree_map(cast, mstate)
        rs = np.random.RandomState(3)
        x = torch.from_numpy(rs.rand(8, 12, 12, 3))
        y = torch.from_numpy(rs.randint(0, 4, 8))
        loss_fn = lambda lo, la: torch.mean(
            losses.softmax_cross_entropy(lo, la))
        opt = O.momentum(0.1, 0.9)
        out = {}
        state = TS.shard_train_state(TrainState.create(
            tree_map(torch.clone, params), tree_map(torch.clone, mstate),
            opt), mesh)
        step = TS.make_sharded_train_step(model, loss_fn, opt, mesh)
        ls = []
        for _ in range(2):
            state, loss, _ = step(state, None, (x,), (y,))
            ls.append(float(loss))
        out["sharded"] = {"losses": ls, "params": full_tree(state.params),
                          "mstate": full_tree(state.model_state)}
        plain = TrainState.create(params, mstate, opt)
        pstep = make_train_step(model, loss_fn, opt)
        ls = []
        for _ in range(2):
            plain, loss, _ = pstep(plain, None, (x,), (y,))
            ls.append(float(loss))
        out["plain"] = {"losses": ls, "params": full_tree(plain.params),
                        "mstate": full_tree(plain.model_state)}
        return out
    finally:
        dtypes.set_default_policy(prev)


# ---- test_torch_zero.py ----


def zero_model():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import layers as L

    # leaf sizes 56, 7, 21, 3: every bias pads to shard
    return nn.module.Sequential([L.Dense(7, name="fc", activation="relu"),
                                 L.Dense(3, name="out")])


def mse(out, y):
    return torch.mean((out - y) ** 2)


ZERO_OPTS = {"sgd": ("sgd", (0.1,)), "momentum": ("momentum", (0.05, 0.9)),
             "adam": ("adam", (1e-2,))}


def zero_cases(rank, world, payload):
    from paddle_tpu_torch.core.pytree import tree_map, tree_map_multi
    from paddle_tpu_torch.models.weights import params_from_numpy
    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.parallel import sharding as S
    from paddle_tpu_torch.parallel import train_step as TS
    from paddle_tpu_torch.train.state import TrainState

    x, y = _t(payload["x"]), _t(payload["y"])
    res = {}
    for shape in ((4, 1, 1), (2, 1, 1)):
        mesh = _mesh(shape)
        if not mesh.contains_me:
            continue
        out = res[shape] = {}
        for name, (fn, args) in ZERO_OPTS.items():
            opt = getattr(O, fn)(*args)
            params = params_from_numpy(payload["params"], device="cpu")
            sz = TrainState.create_zero(params, {}, opt, mesh)
            sb = TrainState.create_zero(params, {}, opt, mesh)
            sb = sb._replace(opt_state=S.place(sb.opt_state, tree_map(
                lambda _: S.replicated(mesh), sb.opt_state)))
            step_z = TS.make_zero_train_step(zero_model(), mse, opt, mesh,
                                             donate=False)
            step_b = TS.make_zero_train_step(zero_model(), mse, opt, mesh,
                                             donate=False, zero_update=False)
            if name == "adam":
                out["create_zero"] = {"params": np_tree(sz.params),
                                      "opt": np_tree(sz.opt_state)}
                out["bytes"] = (TS.opt_state_bytes_per_replica(sz.opt_state),
                                TS.opt_state_bytes_per_replica(sb.opt_state))
            lz, lb = [], []
            for _ in range(3):
                sz, l1, _ = step_z(sz, None, x, y)
                sb, l2, _ = step_b(sb, None, x, y)
                lz.append(float(l1))
                lb.append(float(l2))
            out[name] = {"lz": lz, "lb": lb, "pz": full_tree(sz.params),
                         "pb": full_tree(sb.params),
                         "opt_local": np_tree(sz.opt_state),
                         "opt_b": full_tree(sb.opt_state)}
        # a JAX ZeRO state gathered to numpy (padded for 8 replicas)
        # re-padded for this mesh
        sizes = TS.zero_true_sizes(payload["params"], payload["jax_opt"])
        out["reshard"] = {
            k: np_tree(tree_map_multi(
                lambda a, n: TS.reshard_zero_leaf(a, n, mesh),
                payload["jax_opt"][k], sizes[k]))
            for k in ("m", "v")}
        out["sizes"] = sizes
    try:
        TS.make_zero_train_step(zero_model(), mse, O.sgd(0.1),
                                _mesh((2, 2, 1)))
    except ValueError as e:
        res["dp_only"] = str(e)
    return res



# ---- test_torch_ring_attention.py ----

RING_MESHES = [((1, 1, 2), None), ((1, 1, 4), None), ((2, 1, 2), "data")]
CP_KW = dict(vocab=64, dim=16, n_layers=2, n_heads=4, mlp_ratio=2)


def ring_cases(rank, world, payload):
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.models.weights import params_from_numpy
    from paddle_tpu_torch.parallel import collectives as C
    from paddle_tpu_torch.parallel import ring_attention as RA

    res = {}
    q0, k0, v0, cot = (_t(payload[n]) for n in ("q", "k", "v", "cot"))
    for shape, batch_axis in RING_MESHES:
        mesh = _mesh(shape)
        if not mesh.contains_me:
            continue
        out = res[shape] = {}
        for kind in ("ring", "ulysses"):
            for causal in (False, True):
                fn = RA.make_sequence_parallel_attention(
                    mesh, kind=kind, causal=causal, batch_axis=batch_axis)
                q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
                o = fn(q, k, v)
                full = o.full_tensor()
                grads = torch.autograd.grad(torch.sum(full * cot), (q, k, v))
                dense = RA.dense_attention(q0, k0, v0, causal=causal)
                out[(kind, causal)] = {
                    "out": full.detach().numpy(),
                    "local": o.to_local().detach().numpy(),
                    "grads": [g.numpy() for g in grads],
                    "dense": dense.numpy()}
        params = params_from_numpy(payload["cp_params"], device="cpu")
        toks = _t(payload["cp_tokens"])
        lens = _t(payload["cp_lens"])
        cfg = T.TransformerConfig(**CP_KW, attn_impl="dense")
        for kind in ("ring", "ulysses"):
            for with_lens in (False, True):
                loss_fn = T.make_context_parallel_loss(
                    cfg, mesh, kind=kind, batch_axis=batch_axis)
                live = {n: p for n, p in _named(params)}
                tracked = _rebuild(params, {n: p.detach().requires_grad_()
                                            for n, p in live.items()})
                C.reset_launch_counts()
                loss = loss_fn(tracked, toks, lens if with_lens else None)
                names = sorted(live)
                got = torch.autograd.grad(
                    loss, [_get(tracked, n) for n in names])
                out[("cp", kind, with_lens)] = {
                    "loss": float(loss.detach()),
                    "grads": {n: g.numpy() for n, g in zip(names, got)},
                    "counts": dict(C.launch_counts)}
        for bad in (dict(attn_window=4), dict(moe_experts=2)):
            try:
                T.make_context_parallel_loss(
                    T.TransformerConfig(**CP_KW, **bad), mesh)
            except ValueError as e:
                out[("refused", tuple(bad))] = str(e)
    return res


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, by_name, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_name, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, by_name, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return by_name[prefix[:-1]]


def _get(tree, name):
    for part in name.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


# ---- test_torch_pipeline.py ----


def stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def pipeline_cases(rank, world, payload):
    from paddle_tpu_torch.core import mesh as M
    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.parallel import pipeline as PP

    res = {}
    for n in (4, 2):
        mesh = M.make_mesh((n,), (PP.PIPE_AXIS,), "cpu",
                           ranks=list(range(n)))
        if not mesh.contains_me:
            continue
        out = res[n] = {}
        for name, case in payload["cases"].items():
            if case["stages"] != n:
                continue
            per = [{k: _t(v) for k, v in p.items()} for p in case["per"]]
            stacked = PP.stack_stage_params(per)
            x = _t(case["x"])
            fwd = PP.make_pipeline_forward(stage_fn, mesh)
            got = {"out": fwd(PP.shard_stage_params(stacked, mesh),
                              x).numpy()}
            if "target" in case:
                tgt = _t(case["target"])
                sharded = PP.shard_stage_params(stacked, mesh)
                live = {k: v.detach().requires_grad_()
                        for k, v in sharded.items()}
                loss = torch.mean((fwd(live, x) - tgt) ** 2)
                g = torch.autograd.grad(loss, list(live.values()))
                got["grads_sharded"] = {k: gi.full_tensor().numpy()
                                        for k, gi in zip(live, g)}
                # full plain stacked params: the gradient comes back
                # whole on every rank
                plain = {k: v.clone().requires_grad_()
                         for k, v in stacked.items()}
                loss = torch.mean((fwd(plain, x) - tgt) ** 2)
                g = torch.autograd.grad(loss, list(plain.values()))
                got["grads_plain"] = {k: gi.numpy() for k, gi in
                                      zip(plain, g)}
            if "train" in case:
                opt = O.adam(3e-2)
                params = PP.shard_stage_params(stacked, mesh)
                opt_state = opt.init(params)
                step = PP.make_pipeline_train_step(
                    stage_fn, lambda o, y: torch.mean((o - y) ** 2), opt,
                    mesh)
                losses = []
                for i in range(case["train"]):
                    params, opt_state, loss = step(
                        params, opt_state, x, _t(case["target"]),
                        torch.tensor(i, dtype=torch.int32))
                    losses.append(float(loss))
                got["losses"] = losses
                got["placements"] = str(params["w"].placements)
                got["params"] = full_tree(params)
            out[name] = got
    tp = payload.get("tp")
    if tp is not None:
        res["tp"] = pipeline_tp_case(tp)
    return res


def relu_stage(params, x):
    return torch.relu(x @ params["w"] + params["b"])


def relu_stage_tp(params, x, mm):
    return torch.relu(mm(x, params["w"]) + params["b"])


def pipeline_tp_case(case):
    """The pipeline with `tp_axis` on a (pipe 2, tp 2) mesh over the 4
    ranks: forward in both tp arms and the gradients of sum(out^2)."""
    from paddle_tpu_torch.core import mesh as M
    from paddle_tpu_torch.parallel import pipeline as PP

    mesh = M.make_mesh((2, 2), ("pipe", "tp"), "cpu")
    per = [{k: _t(v) for k, v in p.items()} for p in case["per"]]
    stacked = PP.stack_stage_params(per)
    x = _t(case["x"])
    sharded = PP.shard_stage_params(stacked, mesh, tp_axis="tp")
    out = {"placements": str(sharded["w"].placements),
           "local_w": tuple(sharded["w"].to_local().shape)}
    for arm, overlap in (("overlap", True), ("naive", False)):
        fwd = PP.make_pipeline_forward(relu_stage_tp, mesh, tp_axis="tp",
                                       tp_overlap=overlap)
        with torch.no_grad():
            out[arm] = fwd(sharded, x).numpy()
        live = {k: v.detach().requires_grad_() for k, v in sharded.items()}
        loss = torch.sum(fwd(live, x) ** 2)
        g = torch.autograd.grad(loss, list(live.values()))
        out[f"{arm}_grads"] = {k: gi.full_tensor().numpy()
                               for k, gi in zip(live, g)}
    return out


# ---- test_torch_moe_ep.py ----

# (mesh shape, data_axis): the joint (data, model) token split and the
# replicated-token branch
EP_CASES = [((2, 2, 1), "data"), ((1, 4, 1), "data"), ((1, 2, 1), None),
            ((1, 4, 1), None)]


def moe_ep_cases(rank, world, payload):
    from paddle_tpu_torch.parallel import collectives as C
    from paddle_tpu_torch.parallel import moe

    res = {}
    base = {k: (_t(v) if not isinstance(v, dict) else
                {kk: _t(vv) for kk, vv in v.items()})
            for k, v in payload["params"].items()}
    x0 = _t(payload["x"])
    for shape, data_axis in EP_CASES:
        mesh = _mesh(shape)
        if not mesh.contains_me:
            continue
        out = res[(shape, data_axis)] = {}
        placed = moe.shard_moe_params(base, mesh)
        out["placed"] = np_tree(placed)
        for cf, jitter in ((4.0, 0.0), (1.25, 0.0), (1.25, 0.1)):
            ffn = moe.make_expert_parallel_ffn(
                mesh, data_axis=data_axis, k=2, capacity_factor=cf,
                jitter=jitter)
            noise = None
            if jitter:
                key = "noise_joint" if data_axis else "noise_repl"
                noise = _t(payload[key][shape])
            live = {k: v for k, v in _named(placed)}
            tracked = _rebuild(placed, {n: p.detach().requires_grad_()
                                        for n, p in live.items()})
            x = x0.clone().requires_grad_()
            C.reset_launch_counts()
            o = ffn(tracked, x, jitter_noise=noise)
            loss = torch.mean(o.y.full_tensor() ** 2) + 0.01 * o.aux_loss
            names = sorted(live)
            grads = torch.autograd.grad(
                loss, [_get(tracked, n) for n in names] + [x])
            out[(cf, jitter)] = {
                "y": o.y.full_tensor().detach().numpy(),
                "aux": float(o.aux_loss.detach()),
                "dropped": float(o.dropped.detach()),
                "grads": {n: g.full_tensor().numpy()
                          for n, g in zip(names, grads[:-1])},
                "x_grad": grads[-1].numpy(),
                "counts": dict(C.launch_counts)}
    return res


# ---- test_torch_dryrun.py ----


def dryrun_case(rank, world, payload):
    """dryrun_multichip(world), then dryrun_multichip(2) and (1) (ranks
    [0, 1] and rank 0's meshes; the other ranks build the meshes and
    skip)."""
    from paddle_tpu_torch.graft_entry import dryrun_multichip

    return {n: dryrun_multichip(n, device="cpu") for n in (world, 2, 1)}
