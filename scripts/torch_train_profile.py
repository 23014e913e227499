#!/usr/bin/env python3
"""Where a training step's time goes in the PyTorch/CUDA port, on one card.

    python3 scripts/torch_train_profile.py [--model seq2seq|lstm|lm|moe_lm|
                                            resnet50] [--batch B]

seq2seq (default): seq2seq_attn at bench_seq2seq's width
(benchmarks/suite.py:188: vocab 30000, embed 256, hidden 512, B=64,
source and target length 30, lengths uniform in [15, 30], adam 1e-3),
the bench's hand-rolled step (gradients, then adam's update), encoder
on kernels F and G. lstm: the bench_lstm classifier (suite.py:144:
vocab 10000, embedding = hidden = 512, 2 x LSTM, mean over time,
Dense(2), adam 1e-3, B=64, T=100) through `make_train_step`, on kernels
D and E. lm: the transformer LM at bench_transformer_lm's width
(suite.py:331: vocab 32000, dim 512, 8 layers, 8 heads, remat, bf16
policy, B=4, T=8192, full causal, adam 1e-3, the same batch every
step), the bench's hand-rolled step, attention on kernel A and the
flash backward. moe_lm: the mixture-of-experts LM at bench_moe_lm's
width (suite.py:452: vocab 32000, dim 512, 8 layers, 8 heads, every
other block 8 experts, top-2, capacity 1.25, remat, B=8, T=2048, adam
1e-3, f32, the same batch every step), the bench's step; attention on
kernel A and the flash backward. resnet50: bench_image's step (suite.py:112: ResNet-50,
224x224, bf16 policy, momentum(0.1, mu=0.9), softmax CE,
make_train_step(donate=True), one batch from RandomState(0/1)) at
--batch (default 256), cuDNN benchmark mode on. Seeded random weights
and data, f32 (lm, resnet50: bf16 compute), TF32 off. Then:

- times 10 steps (lm: 5) on the host clock, ending in a sync: ms per
  step;
- profiles 3 steps with torch.profiler (CPU + CUDA activity): the
  device-busy share of the window (union of kernel intervals over wall
  time), kernels per step, and device time by kind and by kernel. For
  lm also by part: kernel A, the flash backward's products and its
  other kernels (the kernels its autograd node launches), the LM head
  with its CE (the kernels of the ops under a `record_function` around
  `transformer._nll` and of their backward nodes, matched by sequence
  number), and the rest. For moe_lm by part, each kernel attributed to
  the innermost CPU event that names a part (a block is one: the remat
  recompute runs inside the backward node that first needs it): kernel
  A, the flash backward, the routing and dispatch (`top_k_routing`,
  the dispatch into [E, C, D] and the combine, under a
  `record_function`, and their backward nodes by sequence number), the
  expert FFN (its products and the rest), the LM head with its CE, and
  the rest. For resnet50 by part, from the CPU op (or
  autograd node, or the optimizer's record_function) that launched each
  kernel, the outermost one that names a part: convolutions split into
  fprop (the forward op's kernels), dgrad and wgrad (the backward's, by
  kernel name) and the layout transforms cuDNN runs inside them; batch
  norm (`_BatchNormTrain`, forward and backward); ReLU; max pools; the
  pads of asymmetric SAME padding; copies and
  casts (`copy_`, `_to_copy`, `contiguous`, `clone`); the optimizer;
  the rest. And the peak device memory of a step.

Prints one JSON line last. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.core import dtypes as TD  # noqa: E402
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map  # noqa: E402
from paddle_tpu_torch.models import resnet as TR  # noqa: E402
from paddle_tpu_torch.models import seq2seq_attn as TS  # noqa: E402
from paddle_tpu_torch.models import transformer as TT  # noqa: E402
from paddle_tpu_torch.nn import layers as NL  # noqa: E402
from paddle_tpu_torch.nn import module as NM  # noqa: E402
from paddle_tpu_torch.nn import recurrent as NR  # noqa: E402
from paddle_tpu_torch.ops import losses as LS  # noqa: E402
from paddle_tpu_torch.optim import optimizers as OPT  # noqa: E402
from paddle_tpu_torch.parallel import moe as PMOE  # noqa: E402
from paddle_tpu_torch.train.state import TrainState  # noqa: E402
from paddle_tpu_torch.train.trainer import Trainer, make_train_step  # noqa

S2S_VOCAB, S2S_EMBED, S2S_H, S2S_B, S2S_LEN = 30000, 256, 512, 64, 30
LSTM_VOCAB, LSTM_H, LSTM_B, LSTM_T = 10000, 512, 64, 100
LM_CFG = dict(vocab=32000, dim=512, n_layers=8, n_heads=8, remat=True)
LM_B, LM_T = 4, 8192
MOE_CFG = dict(vocab=32000, dim=512, n_layers=8, n_heads=8, remat=True,
               moe_experts=8)
MOE_B, MOE_T = 8, 2048
IMAGE_HW = 224
TIMED, PROFILED = 10, 3
OPTIMIZER_SPAN = "optimizer"
HEAD_SPAN = "lm_head_ce"
# the autograd node of the flash operator's registered backward
# (ops.flash_attention.flash_fwd, torch.library.custom_op)
FLASH_BWD_NODE = "GeneratedBackwardFor_paddle_tpu_torch_flash_fwd_defaultBackward"
BLOCK_SPAN = "transformer_block"
ROUTING_SPAN = "moe_routing_dispatch"
EXPERT_SPAN = "moe_expert_ffn"


def kind(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash forward (A)"
    if any(k in n for k in ("gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd",
                            "rnn_fwd", "time_loop::dw_kernel",
                            "time_loop::backward_loop_kernel",
                            "time_loop::forward_loop_kernel",
                            "reduce_splits")):
        return "fused time-loop kernel"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"
    if "index" in n or "scatter" in n or "gather" in n or "embedding" in n:
        return "index/scatter"
    if "reduce" in n or "softmax" in n or "argmax" in n:
        return "reduction"
    return "elementwise/other"


def union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def seq2seq_step_fn():
    """(step(i), target tokens per step): the bench's hand-rolled step."""
    rs = np.random.RandomState(5)
    params = TS.init_params(rs, S2S_VOCAB, S2S_VOCAB, embed_dim=S2S_EMBED,
                            hidden=S2S_H, device="cuda")
    params = tree_map(lambda t: t.requires_grad_(True), params)
    cuda = lambda a: torch.from_numpy(a).cuda()
    shape, half = (S2S_B, S2S_LEN), S2S_LEN // 2
    batches = [(cuda(rs.randint(2, S2S_VOCAB, shape).astype(np.int32)),
                cuda(rs.randint(half, S2S_LEN + 1, S2S_B).astype(np.int32)),
                cuda(rs.randint(2, S2S_VOCAB, shape).astype(np.int32)),
                cuda(rs.randint(half, S2S_LEN + 1, S2S_B).astype(np.int32)))
               for _ in range(4)]
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params)
    leaves = tree_leaves(params)

    def step(i):
        loss = TS.loss(params, *batches[i % len(batches)])
        it = iter(torch.autograd.grad(loss, leaves))
        opt.update(tree_map(lambda _: next(it), params), opt_state, params,
                   torch.tensor(i, dtype=torch.int32, device="cuda"))

    tokens = np.mean([int(b[3].sum()) for b in batches])
    return step, tokens


def lstm_step_fn():
    model = NM.Sequential([
        NL.Embedding(LSTM_VOCAB, LSTM_H, name="emb"),
        NR.LSTM(LSTM_H, name="lstm1"),
        NR.LSTM(LSTM_H, name="lstm2"),
        NL.Lambda(lambda x: x.mean(dim=1), name="pool",
                  out_spec_fn=lambda s: NM.ShapeSpec(
                      (s.shape[0], s.shape[2]), s.dtype)),
        NL.Dense(2, name="fc"),
    ])
    ce = lambda logits, labels: torch.mean(
        LS.softmax_cross_entropy(logits, labels))
    opt = OPT.adam(1e-3)
    trainer = Trainer(model, ce, opt, seed=0)
    box = [trainer.init_state(NM.ShapeSpec((LSTM_B, LSTM_T), torch.int32))]
    train_step = make_train_step(model, ce, opt)
    rs = np.random.RandomState(3)
    batches = [(torch.from_numpy(rs.randint(0, LSTM_VOCAB, (LSTM_B, LSTM_T))
                                 .astype(np.int32)).cuda(),
                torch.from_numpy(rs.randint(0, 2, LSTM_B)).cuda())
               for _ in range(4)]

    def step(i):
        x, y = batches[i % len(batches)]
        box[0], _, _ = train_step(box[0], None, (x,), (y,))

    return step, LSTM_B * LSTM_T


def lm_step_fn():
    """(step(i), tokens per step): the bench's hand-rolled LM step under
    the bf16 policy (left set: the script runs one model), the LM head
    and its CE inside record_function(HEAD_SPAN)."""
    TD.set_default_policy(TD.bf16_compute_policy())
    cfg = TT.TransformerConfig(**LM_CFG)
    params = tree_map(lambda t: t.requires_grad_(True),
                      TT.init_params(0, cfg, device="cuda"))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, LM_CFG["vocab"], (LM_B, LM_T)).astype(np.int32)).cuda()
    nll = TT._nll

    def spanned_nll(*a, **kw):
        with torch.profiler.record_function(HEAD_SPAN):
            return nll(*a, **kw)

    TT._nll = spanned_nll
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params)
    leaves = tree_leaves(params)

    def step(i):
        loss = TT.loss(params, cfg, tokens)
        it = iter(torch.autograd.grad(loss, leaves))
        opt.update(tree_map(lambda _: next(it), params), opt_state, params,
                   torch.tensor(i, dtype=torch.int32, device="cuda"))

    return step, LM_B * LM_T


def spanned(fn, span):
    def run(*a, **kw):
        with torch.profiler.record_function(span):
            return fn(*a, **kw)
    return run


def moe_lm_step_fn():
    """(step(i), tokens per step): bench_moe_lm's step (f32), with each
    block, the routing and dispatch, the expert FFN and the LM head with
    its CE inside record_function spans."""
    cfg = TT.TransformerConfig(**MOE_CFG)
    params = tree_map(lambda t: t.requires_grad_(True),
                      TT.init_params(0, cfg, device="cuda"))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, MOE_CFG["vocab"], (MOE_B, MOE_T)).astype(np.int32)).cuda()
    TT._nll = spanned(TT._nll, HEAD_SPAN)
    TT._block = spanned(TT._block, BLOCK_SPAN)
    for name in ("top_k_routing", "_dispatch_expert_in", "_combine_out"):
        setattr(PMOE, name, spanned(getattr(PMOE, name), ROUTING_SPAN))
    PMOE._expert_ffn = spanned(PMOE._expert_ffn, EXPERT_SPAN)
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params)
    leaves = tree_leaves(params)

    def step(i):
        loss = TT.loss(params, cfg, tokens)
        it = iter(torch.autograd.grad(loss, leaves))
        opt.update(tree_map(lambda _: next(it), params), opt_state, params,
                   torch.tensor(i, dtype=torch.int32, device="cuda"))

    return step, MOE_B * MOE_T


def resnet50_step_fn(batch):
    """(step(i), images per step): bench_image's step under the bf16
    policy (left set: the script runs one model), the optimizer's update
    inside record_function(OPTIMIZER_SPAN)."""
    TD.set_default_policy(TD.bf16_compute_policy())
    torch.backends.cudnn.benchmark = True
    model = TR.resnet(50, num_classes=1000)
    params, mstate = model.init(0, NM.ShapeSpec((batch, IMAGE_HW, IMAGE_HW,
                                                 3)), device="cuda")
    opt = OPT.momentum(0.1, mu=0.9)

    def update(*a):
        with torch.profiler.record_function(OPTIMIZER_SPAN):
            return opt.update(*a)

    spanned = OPT.Optimizer(opt.init, update)
    box = [TrainState.create(params, mstate, spanned)]
    ce = lambda logits, labels: torch.mean(
        LS.softmax_cross_entropy(logits, labels))
    train_step = make_train_step(model, ce, spanned, donate=True)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        batch, IMAGE_HW, IMAGE_HW, 3).astype(np.float32)).cuda()
    y = torch.from_numpy(np.random.RandomState(1).randint(0, 1000,
                                                          batch)).cuda()

    def step(i):
        box[0], _, _ = train_step(box[0], None, (x,), (y,))

    return step, batch


# resnet50's parts, matched in the outermost CPU op, autograd node or
# record_function that names one (lower case)
IMAGE_PARTS = (
    ("optimizer", (OPTIMIZER_SPAN,)),
    ("batch norm", ("_batchnormtrain",)),
    ("conv", ("convolution",)),
    ("relu", ("relu", "threshold_backward")),
    ("max pools", ("max_pool2d", "maxpool2d")),
    ("pads (asymmetric SAME)", ("constant_pad_nd", "constantpadnd")),
    ("copies and casts", ("copy", "contiguous", "clone")),
)


def image_part(name):
    n = name.lower()
    for part, keys in IMAGE_PARTS:
        if any(k in n for k in keys):
            return part
    return None


def conv_kind(kernel, in_backward):
    n = kernel.lower()
    if any(k in n for k in ("nchwtonhwc", "nhwctonchw", "transpose")):
        return "conv: layout transforms"
    if not in_backward:
        return "conv: fprop"
    if "wgrad" in n:
        return "conv: wgrad"
    if "dgrad" in n:
        return "conv: dgrad"
    return "conv: backward, other kernels"


def image_parts(events):
    """Device us of the ResNet step's parts over the profiled window:
    {part: us}, or None when the profiler tied no kernel to a CPU op."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    parts = defaultdict(float)
    tied = [False]

    def walk(ev, part, backward):
        part = part or image_part(ev.name)
        backward = backward or "backward" in ev.name.lower()
        for k in ev.kernels:
            tied[0] = True
            label = part or "rest"
            if part == "conv":
                label = conv_kind(k.name, backward)
            parts[label] += k.duration
        for c in ev.cpu_children:
            walk(c, part, backward)

    for e in cpu:
        if e.cpu_parent is None:
            walk(e, None, False)
    return dict(parts) if tied[0] else None


def subtree_kernels(ev):
    """(name, device us) of every kernel launched under CPU event ev."""
    out = [(k.name, k.duration) for k in ev.kernels]
    for c in ev.cpu_children:
        out += subtree_kernels(c)
    return out


def lm_parts(events):
    """Device us of the LM step's parts over the profiled window, from the
    CPU ops that launched each kernel: {part: us}, or None when the
    profiler tied no kernel to a CPU op (then not measured)."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    flash, head = [], []
    head_seq = set()
    for e in cpu:
        if e.name == HEAD_SPAN:
            stack = [e]
            while stack:
                x = stack.pop()
                if x.sequence_nr >= 0:
                    head_seq.add(x.sequence_nr)
                stack += x.cpu_children
            head += subtree_kernels(e)
    for e in cpu:
        if e.name == FLASH_BWD_NODE:
            flash += subtree_kernels(e)
        elif ("Backward" in e.name and not e.name.startswith("autograd::")
              and e.sequence_nr in head_seq):
            head += subtree_kernels(e)
    if not flash and not head:
        return None
    mm = lambda n: kind(n) == "matmul"
    return {"flash backward: products": sum(d for n, d in flash if mm(n)),
            "flash backward: other": sum(d for n, d in flash if not mm(n)),
            "LM head + CE (fwd and bwd)": sum(d for _, d in head)}


def moe_parts(events):
    """Device us of the MoE LM step's parts over the profiled window, each
    kernel under the innermost CPU event that names a part ({part: us}),
    or None when the profiler tied no kernel to a CPU op."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    span_part = {ROUTING_SPAN: "routing and dispatch",
                 EXPERT_SPAN: "expert FFN", HEAD_SPAN: "LM head + CE",
                 BLOCK_SPAN: "rest", FLASH_BWD_NODE: "flash backward"}
    seq_part = {}
    for e in cpu:
        if e.name in (ROUTING_SPAN, EXPERT_SPAN, HEAD_SPAN):
            stack = list(e.cpu_children)
            while stack:
                x = stack.pop()
                if x.sequence_nr >= 0:
                    seq_part[x.sequence_nr] = span_part[e.name]
                stack += x.cpu_children

    def label(e):
        if e.name in span_part:
            return span_part[e.name]
        if ("Backward" in e.name and not e.name.startswith("autograd::")
                and e.sequence_nr in seq_part):
            return seq_part[e.sequence_nr]
        return None

    parts = defaultdict(float)
    tied = [False]

    def walk(e, part):
        part = label(e) or part
        for k in e.kernels:
            tied[0] = True
            if kind(k.name) == "flash forward (A)":
                parts["flash forward (A)"] += k.duration
            elif part in ("expert FFN", "flash backward"):
                sub = "products" if kind(k.name) == "matmul" else "other"
                parts[f"{part}: {sub}"] += k.duration
            else:
                parts[part or "rest"] += k.duration
        for c in e.cpu_children:
            walk(c, part)

    for e in cpu:
        if e.cpu_parent is None:
            walk(e, None)
    return dict(parts) if tied[0] else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("seq2seq", "lstm", "lm", "moe_lm",
                                        "resnet50"), default="seq2seq")
    ap.add_argument("--batch", type=int, default=256,
                    help="resnet50's batch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    image = args.model == "resnet50"
    step, tokens = dict(seq2seq=seq2seq_step_fn, lstm=lstm_step_fn,
                        lm=lm_step_fn, moe_lm=moe_lm_step_fn,
                        resnet50=lambda: resnet50_step_fn(args.batch))[
                            args.model]()
    unit = "images" if image else "tokens"
    timed = 5 if args.model in ("lm", "moe_lm", "resnet50") else TIMED
    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    for i in range(timed):
        step(i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(PROFILED):
            step(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # device events, less the device-side spans of record_function
    # ranges (user annotations): they overlap kernels already counted
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in (HEAD_SPAN, OPTIMIZER_SPAN)]
    by_name, by_kind = defaultdict(lambda: [0.0, 0]), defaultdict(float)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
        by_kind[kind(e.name)] += dur
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels])
    parts = None
    if args.model == "lm" and kernels:
        parts = lm_parts(events)
        if parts is not None:
            total = sum(e.time_range.end - e.time_range.start
                        for e in kernels)
            parts = {"flash forward (A)": by_kind["flash forward (A)"],
                     **parts}
            parts["rest"] = total - sum(parts.values())
    if args.model == "moe_lm" and kernels:
        parts = moe_parts(events)
    if image and kernels:
        parts = image_parts(events)
    print(f"card: {torch.cuda.get_device_name(0)}, model {args.model}")
    print(f"train step (unprofiled, {timed} steps): {step_ms:.3f} ms = "
          f"{tokens / step_ms * 1e3:.1f} {unit}/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    if kernels:
        print(f"profiled {PROFILED} steps: wall {wall_us / 1e3:.3f} ms, "
              f"device busy {busy_us / 1e3:.3f} ms "
              f"({100 * busy_us / wall_us:.1f}%), "
              f"{len(kernels) / PROFILED:.0f} kernels per step")
        for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"  {k:<24} {v / PROFILED / 1e3:9.3f} ms/step")
        if args.model in ("lm", "moe_lm", "resnet50"):
            if parts is None:
                print("  by part: not measured (the profiler tied no "
                      "kernel to a CPU op)")
            for k, v in (parts or {}).items():
                print(f"  part {k:<28} {v / PROFILED / 1e3:9.3f} ms/step")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
        for name, (t, n) in top:
            print(f"  {t / PROFILED / 1e3:9.3f} ms/step  x{n / PROFILED:6.1f}"
                  f"  {name[:90]}")
    else:
        print("profiler recorded no device activity: device busy share "
              "not measured")
    out = {"card": torch.cuda.get_device_name(0), "model": args.model,
           "step_ms": step_ms, f"{unit}_per_step": float(tokens),
           f"{unit}_per_s": tokens / step_ms * 1e3,
           "peak_memory_bytes": peak,
           "profiled_wall_ms_per_step": wall_us / PROFILED / 1e3,
           "device_busy_share": (busy_us / wall_us if kernels else None),
           "kernels_per_step": len(kernels) / PROFILED,
           "device_ms_per_step_by_kind": {k: v / PROFILED / 1e3
                                          for k, v in by_kind.items()}}
    if args.model in ("lm", "moe_lm", "resnet50"):
        out["device_ms_per_step_by_part"] = None if parts is None else {
            k: v / PROFILED / 1e3 for k, v in parts.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
