"""The port's counterparts of the repo's `__graft_entry__`:

- `entry()`: the flagship image model's forward (ResNet-50, bf16
  compute policy, eval mode) at batch 16, 224x224, on the card;
- `dryrun_multichip(n)`: every distributed path on tiny shapes over an
  n-rank mesh, one sharded training step or forward each, run once by
  every rank of the job (see its docstring).

    python3 -m paddle_tpu_torch.graft_entry
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.nn.module import ShapeSpec

BATCH, HW = 16, 224


def entry(device=None):
    """Return (forward, (params, mstate, x)): forward(params, mstate, x)
    -> logits [16, 1000]. Sets the bf16 compute policy as the default,
    as the JAX entry does. device None means the card (raises without
    one)."""
    dev = resolve_device(device)
    dtypes.set_default_policy(dtypes.bf16_compute_policy())
    model = resnet.resnet(50, num_classes=1000)
    params, mstate = model.init(0, ShapeSpec((BATCH, HW, HW, 3)), device=dev)

    @torch.no_grad()
    def forward(params, mstate, x):
        out, _ = model.apply(params, mstate, x, training=False)
        return out

    x = torch.from_numpy(np.random.RandomState(0).rand(
        BATCH, HW, HW, 3).astype(np.float32)).to(dev)
    return forward, (params, mstate, x)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry forward ok:", tuple(out.shape))


def _signature(counts, kind: str) -> int:
    """Collectives of one kind in a CommDebugMode count."""
    return sum(v for k, v in counts.items() if kind in str(k))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Every distributed path on tiny shapes over an n-rank mesh, one
    training step (or forward) each, as the JAX dryrun runs them; every
    rank of an n-rank job calls it (device None -> cuda, NCCL; "cpu" ->
    gloo). At n = 1 the parts that need two ranks are skipped, as in
    JAX. Returns {"ran": [parts], "skipped": {part: why}, "signatures":
    {...}, "losses": {...}}; raises if a loss is not finite or a part
    lost its collective signature:

    - the toy dp x tp step (ZeRO placement, two microbatches), and the
      transformer TP step and TP decode (TP_RULES), do an all-reduce
      (counted by `CommDebugMode` on the DTensor paths);
    - context parallelism moves K/V by point-to-point sends and never
      all-gathers the sequence; expert parallelism does an all-to-all
      (counted by `parallel.collectives.launch_counts`);
    - the CTR step's sparse exchange stays an all-to-all: it launches
      `all_to_all_single` (at two ranks or more), no all-gather, and no
      all-reduce but the MLP's gradient and the loss (JAX asserts the
      all-to-all in the compiled HLO);
    - the DecodeEngine pool over TP_RULES parameters serves the tokens
      of the single-process pool (skipped at n = 1, as in JAX)."""
    import math

    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.parallel import distributed

    dev = resolve_device(device)
    distributed.ensure_initialized(dev)
    if dist.get_world_size() < n_devices:
        raise ValueError(f"{n_devices} ranks asked for, the job has "
                         f"{dist.get_world_size()}")
    ranks = list(range(n_devices))
    report = {"ran": [], "skipped": {}, "signatures": {}, "losses": {}}

    def finite(part, loss):
        value = float(loss)
        if not math.isfinite(value):
            raise AssertionError(f"dryrun {part}: loss {value}")
        report["losses"][part] = value

    def mesh_of(**cfg):
        return mesh_lib.build_mesh(mesh_lib.MeshConfig(**cfg), dev,
                                   ranks=ranks)

    even = n_devices % 2 == 0 and n_devices > 1
    two = 2 if even else 1
    mesh = mesh_of(data=n_devices // two, model=two)
    if mesh.contains_me:
        with CommDebugMode() as comm:
            finite("toy_dp_tp_zero", _dryrun_toy_step(mesh, n_devices))
        report["signatures"]["toy_all_reduce"] = _signature(
            comm.get_comm_counts(), "all_reduce")
        if two > 1 and not report["signatures"]["toy_all_reduce"]:
            raise AssertionError("dryrun toy dp x tp: no all-reduce")
        report["ran"].append("toy_dp_tp_zero")
    sp_mesh = mesh_of(data=n_devices // two, model=1, seq=two)
    if sp_mesh.contains_me:
        _dryrun_ring(sp_mesh, n_devices, two, dev)
        report["ran"].append("ring_attention")
    if mesh.contains_me:
        _dryrun_sharded_embedding(mesh, n_devices)
        report["ran"].append("sharded_embedding")
    dp_mesh = mesh_of(data=n_devices)
    if dp_mesh.contains_me:
        finite("resnet_dp", _dryrun_resnet_dp(dp_mesh, n_devices))
        report["ran"].append("resnet_dp")
    ctr_mesh = mesh_of(data=1, model=n_devices)
    if ctr_mesh.contains_me:
        finite("ctr_alltoall", _dryrun_ctr_alltoall(ctr_mesh, n_devices,
                                                    report))
        report["ran"].append("ctr_alltoall")
    if dp_mesh.contains_me:
        finite("seq2seq_dp", _dryrun_seq2seq(dp_mesh, n_devices, dev))
        report["ran"].append("seq2seq_dp")
    n_pipe = 4 if n_devices % 4 == 0 else two
    pipe_mesh = (mesh_lib.make_mesh((n_pipe,), ("pipe",), dev,
                                    ranks=ranks[:n_pipe])
                 if n_pipe > 1 else None)
    if pipe_mesh is not None and pipe_mesh.contains_me:
        finite("pipeline", _dryrun_pipeline(pipe_mesh, n_pipe, dev))
        report["ran"].append("pipeline")
    if mesh.contains_me:
        with CommDebugMode() as comm:
            loss, fused, plain = _dryrun_transformer_tp(mesh, n_devices,
                                                        two, dev)
        finite("transformer_tp", loss)
        report["signatures"]["tp_all_reduce"] = _signature(
            comm.get_comm_counts(), "all_reduce")
        if two > 1 and not report["signatures"]["tp_all_reduce"]:
            raise AssertionError("dryrun transformer TP: no all-reduce")
        if abs(fused - plain) >= 5e-3:
            raise AssertionError(f"dryrun transformer TP: fused CE {fused} "
                                 f"vs plain {plain}")
        report["losses"]["tp_fused_ce"] = (fused, plain)
        report["ran"].append("transformer_tp")
    if two > 1 and mesh.contains_me:
        finite("moe_ep", _dryrun_moe_ep(mesh, n_devices, two, dev, report))
        report["ran"].append("moe_ep")
    sp = 4 if n_devices % 4 == 0 else two
    if sp > 1:
        cp_mesh = mesh_of(data=n_devices // sp, model=1, seq=sp)
        if cp_mesh.contains_me:
            finite("transformer_cp", _dryrun_transformer_cp(
                cp_mesh, n_devices, sp, dev, report))
            report["ran"].append("transformer_cp")
    if two > 1 and mesh.contains_me:
        with CommDebugMode() as comm:
            _dryrun_tp_decode(mesh, n_devices, two, dev)
        report["signatures"]["tp_decode_all_reduce"] = _signature(
            comm.get_comm_counts(), "all_reduce")
        if not report["signatures"]["tp_decode_all_reduce"]:
            raise AssertionError("dryrun TP decode: no all-reduce")
        report["ran"].append("tp_decode")
    if two > 1 and mesh.contains_me:
        _dryrun_engine_pool(mesh, dev)
        report["ran"].append("engine_pool")
    elif two == 1:
        report["skipped"]["engine_pool"] = ("tensor parallelism needs an "
                                            "even world size of 2 or more")
    return report


def _dryrun_toy_step(mesh, n):
    """The FULL sharded training step over dp x tp: ZeRO placement of
    the moments, two microbatches."""
    from paddle_tpu_torch.core.mesh import P
    from paddle_tpu_torch.nn.layers import Dense
    from paddle_tpu_torch.nn.module import Sequential
    from paddle_tpu_torch.ops import losses
    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.parallel import train_step as TS
    from paddle_tpu_torch.train.state import TrainState

    model = Sequential([Dense(32, name="fc1", activation="relu"),
                        Dense(32, name="fc2", activation="relu"),
                        Dense(8, name="logits")])
    batch = max(8, n * 2)
    params, mstate = model.init(0, ShapeSpec((batch, 16)), device=mesh.device)
    opt = O.adam(1e-3)
    rules = [("fc1/kernel", P(None, "model")), ("fc2/kernel", P("model", None))]
    state = TS.shard_train_state(TrainState.create(params, mstate, opt),
                                 mesh, param_rules=rules, zero=True)

    def loss_fn(logits, labels):
        return torch.mean(losses.softmax_cross_entropy(logits, labels))

    step = TS.make_sharded_train_step(model, loss_fn, opt, mesh,
                                      param_rules=rules, zero=True,
                                      accum_steps=2)
    x = torch.from_numpy(np.random.RandomState(0).rand(batch, 16).astype(
        np.float32)).to(mesh.device)
    y = torch.from_numpy(np.random.RandomState(1).randint(0, 8, batch)).to(
        mesh.device)
    _, loss, _ = step(state, None, (x,), (y,))
    return loss


def _dryrun_ring(mesh, n, sp, dev):
    """Ring attention over a seq-axis mesh (context parallelism)."""
    from paddle_tpu_torch.parallel import ring_attention as RA

    attn = RA.make_sequence_parallel_attention(mesh, kind="ring",
                                               causal=True, batch_axis="data")
    q = torch.from_numpy(np.random.RandomState(2).rand(n, 2 * sp, 2, 4)
                         .astype(np.float32)).to(dev)
    out = attn(q, q, q)
    if not torch.isfinite(out.to_local()).all():
        raise AssertionError("dryrun ring attention: non-finite output")


def _dryrun_sharded_embedding(mesh, n):
    """The row-sharded embedding over the model axis: the psum lookup on
    a 64 x 8 table, and the owner-routed all-to-all lookup."""
    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.parallel import sparse

    emb = sparse.ShardedEmbedding(vocab=64, dim=8, mesh=mesh)
    table = emb.init(1)
    batch = max(8, n * 2)
    r = np.random.RandomState(2)
    ids = torch.from_numpy(r.randint(0, 64, (batch,))).to(mesh.device)
    vecs = emb.lookup(table, ids)
    n_model = mesh.shape["model"]
    k = batch - (batch % n_model) or n_model
    vecs2 = emb.alltoall_lookup(table, ids[:k])
    if not torch.equal(mesh_lib.gather_full(vecs2), vecs[:k]):
        raise AssertionError("dryrun sharded embedding: the all-to-all "
                             "lookup differs from the psum lookup")


def _dryrun_ctr_alltoall(mesh, n, report):
    """The CTR wide & deep sparse train step: row-sharded tables over the
    model axis, the owner-routed all-to-all lookup and row-gradient push.
    The exchange must stay an all-to-all: `all_to_all_single` launched
    (at n >= 2), no all-gather, and no all-reduce but one per MLP
    gradient leaf and the loss's -- never a table shard's."""
    from paddle_tpu_torch.core.pytree import tree_leaves
    from paddle_tpu_torch.models.ctr import CTRModel
    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.parallel import collectives as C

    model = CTRModel(vocab=256, embed_dim=8, mesh=mesh, exchange="alltoall")
    batch, slots = 2 * n, 4
    r = np.random.RandomState(5)
    params, mlp_state = model.init(0, batch, slots)
    opt = O.adam(1e-3)
    opt_state = opt.init(params["mlp"])
    step = model.make_train_step(opt, mlp_state)
    dev = mesh.device
    ids = torch.from_numpy(r.randint(0, 256, (batch, slots)).astype(
        np.int32)).to(dev)
    labels = torch.from_numpy(r.randint(0, 2, batch).astype(np.int32)).to(
        dev)
    C.reset_launch_counts()
    params, opt_state, loss = step(params, opt_state, ids, labels, 0.05,
                                   torch.zeros((), dtype=torch.int32,
                                               device=dev))
    counts = dict(C.launch_counts)
    report["signatures"]["ctr_all_to_all"] = counts["all_to_all"]
    report["signatures"]["ctr_all_gather"] = counts["all_gather"]
    report["signatures"]["ctr_all_reduce"] = counts["all_reduce"]
    mlp_leaves = len(tree_leaves(params["mlp"]))
    if n > 1 and (not counts["all_to_all"] or counts["all_gather"]
                  or counts["all_reduce"] != mlp_leaves + 1):
        raise AssertionError(f"CTR sparse step lost its all-to-all: "
                             f"collectives {counts}")
    return loss


def _dryrun_engine_pool(mesh, dev):
    """The continuous-batching DecodeEngine pool over TP_RULES (megatron-
    sharded) parameters: its K/V arenas split their heads over the model
    axis, and it serves requests token-equal to the single-device pool."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import sharding as S
    from paddle_tpu_torch.serve.engine import DecodeEngine

    cfg = T.TransformerConfig(vocab=64, dim=16, n_layers=2, n_heads=2,
                              attn_impl="dense")
    params = T.init_params(0, cfg, device=dev)
    sharded = S.place(params, S.make_param_shardings(params, mesh,
                                                     T.TP_RULES))
    prompts = [np.random.RandomState(13 + i).randint(
        0, 64, (4 + i,)).astype(np.int32) for i in range(3)]
    got_tp = DecodeEngine(sharded, cfg, slots=2, max_len=16,
                          device=dev).serve(prompts, max_new=4)
    got_1d = DecodeEngine(params, cfg, slots=2, max_len=16,
                          device=dev).serve(prompts, max_new=4)
    if got_tp != got_1d:
        raise AssertionError(f"dryrun engine pool: TP tokens {got_tp} != "
                             f"single-device {got_1d}")


def _dryrun_resnet_dp(mesh, n):
    """ResNet-50's FULL sharded train step (forward, backward, momentum
    update) batch-sharded over the data axis, tiny images."""
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import losses
    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.parallel import train_step as TS
    from paddle_tpu_torch.train.state import TrainState

    model = resnet.resnet(50, num_classes=10)
    batch, hw = 2 * n, 32
    params, mstate = model.init(0, ShapeSpec((batch, hw, hw, 3)),
                                device=mesh.device)
    opt = O.momentum(0.1, mu=0.9)
    state = TS.shard_train_state(TrainState.create(params, mstate, opt), mesh)

    def loss_fn(logits, labels):
        return torch.mean(losses.softmax_cross_entropy(logits, labels))

    step = TS.make_sharded_train_step(model, loss_fn, opt, mesh)
    x = torch.from_numpy(np.random.RandomState(3).rand(batch, hw, hw, 3)
                         .astype(np.float32)).to(mesh.device)
    y = torch.from_numpy(np.random.RandomState(4).randint(0, 10, batch)).to(
        mesh.device)
    _, loss, _ = step(state, None, (x,), (y,))
    return loss


def _dryrun_seq2seq(mesh, n, dev):
    """The seq2seq-attention train step data-parallel: each rank's rows
    through the encoder and decoder (the GRU kernels F and G on the
    card), the global token-mean loss summed over ranks, the parameters
    entering through `pvary` so each rank's gradient is the whole one,
    and adam's update on every rank."""
    from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
    from paddle_tpu_torch.models import seq2seq_attn
    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.parallel import collectives as C

    vocab, hidden, embed = 64, 16, 8
    batch, src_len, tgt_len = 2 * n, 6, 5
    params = seq2seq_attn.init_params(0, vocab, vocab, embed_dim=embed,
                                      hidden=hidden, device=dev)
    opt = O.adam(1e-3)
    opt_state = opt.init(params)
    r = np.random.RandomState(6)
    src = r.randint(2, vocab, (batch, src_len)).astype(np.int32)
    tgt = r.randint(2, vocab, (batch, tgt_len)).astype(np.int32)
    src_lens = r.randint(src_len // 2, src_len + 1, batch)
    tgt_lens = r.randint(tgt_len // 2, tgt_len + 1, batch)
    i, k = mesh.axis_index("data"), batch // n
    rows = slice(i * k, (i + 1) * k)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)
    total = float(np.minimum(tgt_lens, tgt_len).sum())
    mine = float(np.minimum(tgt_lens[rows], tgt_len).sum())
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(live)
    tracked = tree_map(lambda _: C.pvary(next(it), "data", mesh=mesh),
                       params)
    local = seq2seq_attn.loss(tracked, put(src), put(src_lens), put(tgt),
                              put(tgt_lens))
    loss = C.all_reduce_sum(local * (mine / total), "data", mesh=mesh)
    it = iter(torch.autograd.grad(loss, live))
    grads = tree_map(lambda _: next(it), params)
    opt.update(grads, opt_state, params,
               torch.zeros((), dtype=torch.int32, device=dev))
    return loss.detach()


def _dryrun_pipeline(mesh, n_pipe, dev):
    """Pipeline parallelism: stacked homogeneous stages over the pipe
    axis, GPipe ticks, one training step."""
    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.parallel import pipeline as PP

    r = np.random.RandomState(8)
    per_stage = [{"w": torch.from_numpy((r.randn(8, 8) * 0.3).astype(
        np.float32)).to(dev), "b": torch.zeros(8, device=dev)}
        for _ in range(n_pipe)]
    stacked = PP.shard_stage_params(PP.stack_stage_params(per_stage), mesh)
    opt = O.sgd(0.1)
    opt_state = opt.init(stacked)
    micro_x = torch.from_numpy(r.randn(3, 2, 8).astype(np.float32)).to(dev)
    micro_y = torch.from_numpy(r.randn(3, 2, 8).astype(np.float32)).to(dev)
    step = PP.make_pipeline_train_step(
        lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
        lambda out, y: torch.mean((out - y) ** 2), opt, mesh)
    _, _, loss = step(stacked, opt_state, micro_x, micro_y,
                      torch.zeros((), dtype=torch.int32, device=dev))
    return loss


def _dryrun_transformer_tp(mesh, n, tp, dev):
    """The LM's train step under dp x tp (TP_RULES; GQA, so the narrowed
    fused QKV width must split), then the fused chunked CE against the
    vocab-sharded head beside the plain CE."""
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.optim import optimizers as O
    from paddle_tpu_torch.parallel import sharding as S

    cfg = T.TransformerConfig(vocab=64, dim=16, n_layers=2, n_heads=2,
                              n_kv_heads=1, attn_impl="dense")
    params = T.init_params(0, cfg, device=dev)
    params = S.place(params, S.make_param_shardings(params, mesh,
                                                    T.TP_RULES))
    opt = O.adam(1e-3)
    opt_state = opt.init(params)
    batch = 2 * (n // tp)
    toks = S.place(torch.from_numpy(np.random.RandomState(7).randint(
        0, 64, (batch, 8)).astype(np.int32)).to(dev), S.batch_sharding(mesh))
    with implicit_replication():
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(live)
        loss = T.loss(tree_map(lambda _: next(it), params), cfg, toks)
        it = iter(torch.autograd.grad(loss, live))
        opt.update(tree_map(lambda _: next(it), params), opt_state, params,
                   torch.zeros((), dtype=torch.int32, device=dev))
        with torch.no_grad():
            fused = T.loss(params, dataclasses.replace(cfg, fused_ce_chunk=4),
                           toks)
            plain = T.loss(params, cfg, toks)
    full = lambda t: float(t.full_tensor() if hasattr(t, "full_tensor")
                           else t)
    return full(loss.detach()), full(fused), full(plain)


def _dryrun_moe_ep(mesh, n, ep, dev, report):
    """The expert-parallel MoE FFN: experts over the model axis, tokens
    over (data, model), one gradient through the all-to-all dispatch."""
    from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
    from paddle_tpu_torch.parallel import collectives as C
    from paddle_tpu_torch.parallel import moe

    t, d = 4 * n, 8
    params = moe.shard_moe_params(
        moe.init_moe_params(0, ep * 2, d, 16, device=dev), mesh)
    x = torch.from_numpy(np.random.RandomState(9).randn(t, d).astype(
        np.float32)).to(dev)
    ffn = moe.make_expert_parallel_ffn(mesh, data_axis="data", k=2,
                                       capacity_factor=4.0)
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(live)
    C.reset_launch_counts()
    out = ffn(tree_map(lambda _: next(it), params), x)
    loss = torch.mean(out.y.full_tensor() ** 2) + 0.01 * out.aux_loss
    torch.autograd.grad(loss, live)
    report["signatures"]["moe_all_to_all"] = C.launch_counts["all_to_all"]
    if not C.launch_counts["all_to_all"]:
        raise AssertionError("dryrun MoE EP step lost its all-to-all")
    return loss.detach()


def _dryrun_transformer_cp(mesh, n, sp, dev, report):
    """Context parallelism on the LM: the sequence over the seq axis,
    every attention layer ring attention, one gradient."""
    from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import collectives as C

    cfg = T.TransformerConfig(vocab=64, dim=16, n_layers=2, n_heads=2,
                              mlp_ratio=2, attn_impl="dense")
    params = T.init_params(0, cfg, device=dev)
    batch = 2 * (n // sp)
    toks = torch.from_numpy(np.random.RandomState(11).randint(
        0, 64, (batch, 4 * sp + 1)).astype(np.int32)).to(dev)
    cp_loss = T.make_context_parallel_loss(cfg, mesh, batch_axis="data")
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(live)
    C.reset_launch_counts()
    loss = cp_loss(tree_map(lambda _: next(it), params), toks)
    torch.autograd.grad(loss, live)
    counts = dict(C.launch_counts)
    report["signatures"]["cp_ppermute"] = counts["ppermute"]
    report["signatures"]["cp_all_gather"] = counts["all_gather"]
    # the ring moves K/V by sends and never gathers the sequence
    if not counts["ppermute"] or counts["all_gather"]:
        raise AssertionError(f"dryrun CP: collectives {counts}")
    return loss.detach()


def _dryrun_tp_decode(mesh, n, tp, dev):
    """Tensor-parallel greedy decode: TP_RULES parameters, a
    batch-sharded prompt, prefill and generation on DTensors."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import sharding as S

    cfg = T.TransformerConfig(vocab=64, dim=16, n_layers=2, n_heads=2,
                              attn_impl="dense")
    params = T.init_params(0, cfg, device=dev)
    params = S.place(params, S.make_param_shardings(params, mesh,
                                                    T.TP_RULES))
    batch = 2 * (n // tp)
    prompt = S.place(torch.from_numpy(np.random.RandomState(12).randint(
        0, 64, (batch, 6)).astype(np.int32)).to(dev), S.batch_sharding(mesh))
    out = T.generate(params, cfg, prompt, steps=4)
    if tuple(out.shape) != (batch, 10):
        raise AssertionError(f"dryrun TP decode: shape {tuple(out.shape)}")


class LMLoss:
    """The LM's next-token loss as a layer for the train steps
    (`train.trainer.make_train_step`, `parallel.make_sharded_train_step`,
    `parallel.make_zero_train_step`): apply(params, state, tokens) ->
    (transformer.loss, state); pair it with the identity loss_fn."""

    name = None

    def __init__(self, cfg):
        self.cfg = cfg

    def apply(self, params, state, tokens, *, training=False, rng=None):
        from paddle_tpu_torch.models import transformer as T

        return T.loss(params, self.cfg, tokens), state

    __call__ = apply


def identity_loss(out):
    return out
