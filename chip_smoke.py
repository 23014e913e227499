#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (paddle_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build  -- compile every CUDA kernel of the serving and training
   paths from paddle_tpu_torch/csrc (one nvcc per source, all at once).
2. kernels -- hold each kernel against its plain PyTorch version on the
   card, case by case, and time both (CUDA events around device work
   only, L2 flushed before every call, as a serving step finds it
   cold), beside the least time the card could take (`bound_ms`) and,
   for flash attention,
   `torch.nn.functional.scaled_dot_product_attention` as a yardstick.
   A: flash attention forward; B and C: the ragged walk over float
   arenas (B) and over int8 (s8, scale) arenas, dequant fused (C), both
   split over pages across blocks (the plan, `walk_plan`: splits, keys
   per split and blocks, and the device launches per call -- the walk,
   and the combine of the splits' partials where there are several,
   which must be 1 or 2 -- are printed per case; each case must repeat
   its output bit for bit on a second call; B's and C's cases add rows
   that reach max_len (pos0 = 255) and inactive rows whose mean of V
   spans every split). The build's step prints each walk
   instantiation's shared memory, registers, spills and blocks resident
   per SM, which must let 2 x SMs blocks of the plan be resident.
   Tolerances: float32 1e-4, bfloat16 2e-2, on outputs of unit scale.
   A runs its products on the tensor cores (bf16 mma.sync; f32 as
   3xTF32): the count of HMMA instructions in each flash_fwd_kernel
   instantiation, read from `cuobjdump --dump-sass` of the built library,
   must be above 0. A's cases: the main prefill, key_lens, causal T=2048,
   a sliding window, head_dim 128 and rows with no valid key, in f32 and
   bf16; causal T=8192, B=4, H=8 in bf16 and f32 (bench_transformer_lm's
   shape; the LM train phase feeds it f32, its f32 biases promoting the
   activations; held against the plain version one batch row at a time:
   its scores take 2 GB a row; the bf16 output's tolerance holds each
   row's max abs error over that row's max |plain|, since a long row's
   |o| falls to bf16's absolute tolerance, the f32 one its max abs
   error); and f32 scores of std 3 (q scaled by 3)
   at f32's tolerance. A's f32 bound counts its products at the 3xTF32
   rate (495 / 3 TFLOP/s); the time loops' f32 bounds at the CUDA
   cores' 67 TFLOP/s.
   D and E: the fused LSTM time loop, forward and backward, at
   bench_lstm's shape (T=100, B=64, H=512) with full, ragged ([50, 100])
   and reversed ragged lengths and nonzero h0/c0, at H=256 B=128 and
   H=1280 B=64, and with bf16 x_proj and w_hh; E gets random
   cotangents. D runs on the forward loop of time_loop.cuh (a memset of
   its barrier counters and one cooperative launch: 2 device operations
   per call, printed with its us per step) and must repeat hs and cs
   bit for bit. Error: max abs error over max |plain| (dW sums T*B
   terms), same tolerances. cuDNN's torch.nn.LSTM is the yardstick,
   its input projection timed beside it. E runs in three phases (the
   gates of every step as one tiled product; the serial loop, one
   cooperative launch over row groups x unit groups with only the
   carry's product in it; dW_hh as a split tiled product summed in a
   fixed order): every E case must repeat all its outputs bit for bit
   on a second call, and at the main shape the device time of each
   phase is printed (CUDA events the wrapper records between its
   launches).
   F and G: the fused GRU time loop (csrc/fused_gru.cu; F on the
   forward loop of time_loop.cuh, a memset of its barrier counters and
   one cooperative launch, repeating hs bit for bit), forward and
   backward, at the seq2seq encoder's shape (T=30, B=64, H=512) with
   full, ragged ([15, 30]) and reversed ragged lengths, nonzero h0, and
   bf16 x_proj and w_hh; H and I: the fused tanh-RNN time loop
   (csrc/fused_rnn.cu; H on the same forward loop with a one-gate cell,
   a memset and one cooperative launch, repeating hs bit for bit) at
   T=100, B=64, H=512, full, ragged ([50, 100]), reversed, nonzero h0
   and bf16 with nonzero h0. F and H must make 2 device operations per
   call and print their us per step. The backward kernels get random
   cotangents; the
   error measure and tolerances are D/E's. G has E's three phases and I
   two (the serial loop on the shared backward loop after a memset of
   its barrier counters, dW_hh): their cases
   repeat bit for bit, and their main cases print the phase split.
   E, G, I, F, D and H then run alone at their loop's other grids
   (`WIDE_CASES`: w_hh's rows read through L2 at H >= 1536 (I and H
   from H=2816), 2, 4 or 8 pairs per thread at wide H or B; I at B=64,
   H=2048, F at B=64, H >= 1536 and H at B=64, H >= 2816, which their
   one-launch designs refused; D at B=64, H=1536 and 2048 from L2, in
   f32 and bf16, and at B=256, H=1024; H at B=64 H=2048 (f32, bf16),
   B=256 H=1024 and B=100 H=2560, the shape only H's one-gate tile
   bounds take), ragged with nonzero initial state, against their
   plain versions and bit for bit on a second call.
   Yardsticks: cuDNN's
   torch.nn.GRU(256, 512) with b_hn zeroed (the port's n gate) and
   torch.nn.RNN(512, 512, tanh), their input projections timed beside
   them. Bounds count live (row, step) pairs.
3. serve  -- the transformer LM at the serving benchmark's width (vocab
   32000, dim 512, 8 layers, 8 heads, f32) with seeded random weights
   through DecodeEngine(slots=8, max_len=256, page_size=16). Each path
   below runs with every launch count set to 0 just before it, and
   each kernel it should use must have launched; the same requests
   then go through the plain path (dense attention, the ragged walk's
   plain version) and the greedy tokens must agree -- where they
   differ, the plain path's top-2 logit gap at the first differing step
   must be <= 1e-3 (a near tie, not a fault).
   - float KV: 32 requests (128-token prompts, half sharing a 64-token
     prefix, 128 new tokens) launch A and B (TQ=1 and TQ>1). Four
     sampled requests must repeat their tokens under the same seeds,
     and the plain engine must match generate() on two requests.
   - int8 KV (kv_cache_dtype="int8"): the same 32 requests launch A and
     C (TQ=1 and TQ>1).
   - int8 weights (serve.quant.quantize_params), float KV: 8 requests.
   - speculative (serve(speculative=True), NGramProposer, 4 drafts), on
     the float and the int8 pool: 16 requests, half repeating a
     16-token motif; tokens agree with the same engine's one-token
     decode, and every verify round read the cache through B or C with
     TQ=5 (at least rounds x layers TQ>1 launches).
4. train  -- the bench_lstm classifier (benchmarks/suite.py:144: vocab
   10000, embedding = hidden = 512, 2 x nn.LSTM, mean over time,
   Dense(2), adam 1e-3; B=64, T=100) with seeded random weights through
   the port's Trainer for 10 steps over 4 seeded batches, launch counts
   set to 0 just before: exactly 2 D and 2 E launches per step, each D
   call making 2 device operations and each E call at least three
   device launches (its phases, counted by the wrapper as it launches
   them). The
   same weights then train on the plain path (nn.LSTM(impl="torch")):
   first-step gradients agree to 1e-4 relative, every loss to 1e-3.
   Then text_lstm at the same width (max pool) on lengths uniform in
   [50, 100]: one forward and backward launches D and E twice each, and
   its gradients agree with the plain path's to 1e-4 relative.
5. seq2seq -- seq2seq_attn at bench_seq2seq's width
   (benchmarks/suite.py:188: vocab 30000, embed 256, hidden 512, B=64,
   source and target length 30, lengths uniform in [15, 30], adam 1e-3)
   with seeded random weights, 10 hand-rolled steps (gradients, then
   adam's update) over 4 seeded batches, launch counts set to 0 just
   before: exactly 2 F and 2 G launches per step (the bidirectional
   encoder; two device launches per F call, at least three per G
   call), no H or I. The same weights then train on the plain path
   (impl="torch", none of F-I launches): first-step gradients agree to
   1e-4 relative (each leaf on its own scale, floored at 1e-6 of the
   largest gradient), every loss to 1e-3. Target tokens/s is
   sum(tgt_lens) over the steps / wall time, the bench's definition.
6. generation -- generate(beam_size=4, max_len=30) and greedy_generate
   on 16 source rows with the trained weights, on the kernels (2 F
   launches per call, 4 device launches, no G) and on the plain path:
   tokens and lengths
   equal, except at a near tie (greedy: the plain path's top-2 logit
   gap at the first differing step <= 1e-3; beam: the plain search's
   smallest gap among its K+1 best candidates or final scores <= 1e-3);
   beam scores within 1e-4 relative.
7. simple_rnn -- ops.rnn.simple_rnn at T=100, B=64, H=512 on lengths
   uniform in [50, 100]: one forward and backward launches H and I once
   each (H 2 device launches, I at least three), and its gradients
   agree with the plain path's to 1e-4 relative.
8. lm_train -- the transformer LM's training path at
   bench_transformer_lm's width (benchmarks/suite.py:331: vocab 32000,
   dim 512, 8 layers, 8 heads, remat, bf16 policy, B=4, T=8192, adam
   1e-3, seeded weights, the same batch every step). First the flash
   backward's cases: flash_attention's gradients on the card (kernel A
   forward, the ported blockwise backward) against torch.autograd
   through the plain version, random cotangents, causal T=2048 in f32
   and bf16, key_lens, a window of 256 at T=2048, head_dim 128, and
   causal T=8192 B=4 bf16 (held one batch row at a time); max abs error
   over max |plain| per gradient within f32 1e-4 / bf16 2e-2. The
   backward alone at T=8192 B=4 is timed beside SDPA's backward and its
   bound (2.5 x the forward's products). Then three variants (full
   causal, attn_window 1024, fused_ce_chunk 2048), a warm-up step and 5
   timed steps each: ms/step, tokens/s (B x T over the step), the
   step's analytic FLOP count and its share of 989 TFLOP/s (mfu_pct);
   A's launches counted from 0 before the warm-up must be 16 a step (a
   forward and a remat recompute per layer), no dense attention or flash
   plain version may run, every loss finite and the last below the
   first, and the fused CE's first loss within 1e-3 of the unfused one.
   Then parity with the plain path (the flash Function's forward on the
   plain version, which must not launch A) from the same weights at T
   cut to 2048, 3 steps, f32 (first-step gradients per leaf 1e-4, floored
   as seq2seq's, losses 1e-3) and bf16 (2e-2, 1e-2); and a checkpoint
   round trip: CheckpointManager(max_to_keep=2) over 3 steps keeps 2 and
   3, restores them into a fresh template leaf for leaf, one more step
   from both gives the same loss bit for bit, and the parameters tar
   round-trips the params exactly.
9. image -- the image models (no kernel of their own: cuDNN convs, torch
   pools, BN as a torch-ops autograd Function). Parity with the port's
   CPU path from the same weights: resnet50 (B=4), googlenet, alexnet,
   vgg19 (B=2, 224x224) and smallnet (32x32): f32 eval logits 1e-4,
   loss 1e-3; f64 on both devices (logits, loss, every gradient and BN
   state) 1e-4; the f32 step op by op (`OpReplay`: every op the card
   runs against the same op on the CPU on the card's inputs, 1e-4,
   max-pool indices equal); its gradients and BN state leaf by leaf at
   1e-4 where the CPU's own one-ulp spread stays under 1e-5 (AlexNet,
   SmallNet; elsewhere an ulp decides near ties or BN batch statistics,
   and the errors are printed); resnet50 also under the bf16 policy
   (eval logits 2e-2, loss 1e-2, op by op 2e-2) and 3 momentum steps
   (f64: losses 1e-3, BN state 1e-4; f32 and bf16 printed). Then
   bench_image's configs (benchmarks/suite.py:112, :765-775; bf16,
   momentum(0.01, mu=0.9) --
   the bench's lr 0.1 diverges on one repeated batch, in JAX as in the
   port --, softmax CE, make_train_step(donate=True), cuDNN benchmark
   mode): resnet50 B=64 and 256, its s2d and both remat variants at 256,
   alexnet 128, googlenet 128, vgg19 64, smallnet 512: 1 + 5 timed steps
   (ms_per_batch, imgs_per_sec, mfu_pct, peak memory; every loss finite,
   the last below the first, BN running stats moved). bench_trainer_loop
   (resnet50 B=64 through Trainer.train) beside the raw step, alexnet
   with its dropout through Trainer.train (the masks drawn on the card),
   and graft_entry.entry() (finite [16, 1000] logits).
10. report -- the launch counts of every path, the serve, train, seq2seq,
   generation, LM train and image numbers, the wide cases, the card's
   name and power limit, a `kernels` JSON line (nine entries, A-I; A adds its
   HMMA counts and its launches in the LM train phase; B and C their
   device launches in the float and int8
   serves and per call and their split plan; D, F and H their device
   launches and whether they repeated bit for bit (D and H also their
   us per step); E, G and I their
   device launches in the main path's run and
   per call, their phase split and whether they repeated bit for bit),
   and last the device JSON line.

One phase alone, on the card: `python3 -c "import chip_smoke as S;
S.seq2seq_phase()"` (each phase builds what it launches at first use).

TF32 is switched off for matmuls and cuDNN, so float32 means float32.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch import graft_entry as GRAFT
from paddle_tpu_torch.core import dtypes as TD
from paddle_tpu_torch.core.pytree import (tree_leaves, tree_map,
                                          tree_map_with_name)
from paddle_tpu_torch.models import alexnet as IM_ALEXNET
from paddle_tpu_torch.models import googlenet as IM_GOOGLENET
from paddle_tpu_torch.models import resnet as IM_RESNET
from paddle_tpu_torch.models import seq2seq_attn as TS
from paddle_tpu_torch.models import smallnet as IM_SMALLNET
from paddle_tpu_torch.models import text_lstm as TTL
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models import vgg as IM_VGG
from paddle_tpu_torch.nn import layers as NL
from paddle_tpu_torch.nn import module as NM
from paddle_tpu_torch.nn import recurrent as NR
from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.ops import flash_attention as FA
from paddle_tpu_torch.ops import fused_gru as FG
from paddle_tpu_torch.ops import fused_lstm as FL
from paddle_tpu_torch.ops import fused_rnn as FR
from paddle_tpu_torch.ops import losses as LS
from paddle_tpu_torch.ops import paged_attention as PA
from paddle_tpu_torch.ops import ragged_paged_attention as RPA
from paddle_tpu_torch.ops import rnn as RNN
from paddle_tpu_torch.serve import quant as Q
from paddle_tpu_torch.optim import optimizers as OPT
from paddle_tpu_torch.serve.engine import DecodeEngine
from paddle_tpu_torch.train import checkpoint as CK
from paddle_tpu_torch.train import events as EV
from paddle_tpu_torch.train.state import TrainState
from paddle_tpu_torch.train.trainer import (Trainer, loss_and_grads,
                                            make_train_step)

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12,           # f32, CUDA cores
              torch.bfloat16: 989e12}         # bf16, dense tensor cores
# A's f32 products run as 3xTF32 on the tensor cores: three TF32 products
# (dense 495 TFLOP/s) for each f32 one
PEAK_3XTF32 = 495e12 / 3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GAP_LIMIT = 1e-3

SERVE_CFG = dict(vocab=32000, dim=512, n_layers=8, n_heads=8)
SLOTS, MAX_LEN, PAGE = 8, 256, 16
N_REQ, PROMPT, SHARED, MAX_NEW = 32, 128, 64, 128
N_WEIGHT_REQ, N_SPEC_REQ = 8, 16

# bench_lstm(hidden=512, batch=64, seq_len=100, vocab=10000)
# (benchmarks/suite.py:144, sizes at :778-781)
LSTM_T, LSTM_B, LSTM_H, LSTM_VOCAB = 100, 64, 512, 10000
TRAIN_STEPS, TRAIN_BATCHES = 10, 4
LOSS_RTOL, GRAD_RTOL = 1e-3, 1e-4

# bench_seq2seq(batch=64, src_len=tgt_len=30, hidden=512, embed=256,
# vocab=30000) (benchmarks/suite.py:188, sizes at :803-808)
S2S_VOCAB, S2S_EMBED, S2S_H, S2S_B, S2S_LEN = 30000, 256, 512, 64, 30
GEN_ROWS, GEN_BEAM, GEN_MAX_LEN = 16, 4, 30
SCORE_RTOL = 1e-4
# the tanh RNN at the reference RNN benchmark's shape (bench_lstm's)
RNN_T, RNN_B, RNN_H = 100, 64, 512
# bench_transformer_lm(seq_len=8192, batch=4, dim=512, n_layers=8,
# n_heads=8, vocab=32000) with remat, bf16 policy (benchmarks/suite.py:331,
# sizes at :819-833, policy at :759), also with window 1024 and the fused
# CE over 2048-position chunks (:856-866)
LM_CFG = dict(vocab=32000, dim=512, n_layers=8, n_heads=8, remat=True)
LM_B, LM_T, LM_SEED = 4, 8192, 0
LM_WINDOW, LM_CE_CHUNK, LM_STEPS = 1024, 2048, 5
# parity with the plain path: the sequence cut to 2048, 3 steps;
# (first-step gradient, loss) tolerances per compute dtype
LM_PARITY_T, LM_PARITY_STEPS = 2048, 3
LM_PARITY_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 1e-2)}


def log(*a):
    print(*a, flush=True)


class Fail(RuntimeError):
    pass


# -- timing ------------------------------------------------------------------

_FLUSH = None
# ~5 ms at the H100's clock: while the GPU spins, the host queues the
# whole timed call, so the events bracket device work only
_SPIN_CYCLES = 10_000_000


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` calls. Before each call the
    L2 is flushed (a 64 MB write, as a serving step finds the cache
    cold) and the GPU spins while the host enqueues the call, so host
    launch overhead stays outside the CUDA events around it."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        _FLUSH.zero_()
        torch.cuda._sleep(_SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


PHASES = ("gates", "loop", "dw")


def phase_ms(bwd, bargs, names=PHASES, iters=10, warmup=2):
    """Mean device ms of each phase of one call of a redesigned backward
    kernel (E, G: gates, loop, dW; I: loop, dW): the wrapper records four
    CUDA events, before its first launch and after each phase (I's first
    phase is empty). L2 flushed before each call, as in time_ms."""
    time_ms(lambda: bwd(*bargs), iters=1, warmup=warmup)
    sums = [0.0, 0.0, 0.0]
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        _FLUSH.zero_()
        torch.cuda._sleep(_SPIN_CYCLES)
        bwd(*bargs, events=ev)
        torch.cuda.synchronize()
        for i in range(3):
            sums[i] += ev[i].elapsed_time(ev[i + 1])
    return {n: x / iters for n, x in zip(PHASES, sums) if n in names}


def log_phases(kern, phases, ms, steps):
    gates = (f"gates {phases['gates']:.4f}, " if "gates" in phases
             else "")
    log(f"    {kern} phases (device ms, mean of 10 calls): {gates}serial "
        f"loop {phases['loop']:.4f} ({phases['loop'] / steps * 1e3:.2f} us "
        f"per step), dW {phases['dw']:.4f}; sum "
        f"{sum(phases.values()):.4f} vs kernel_ms {ms:.4f}")


def bitwise_repeat(bwd, bargs, first):
    """Does a second call on the same inputs give every output bit for
    bit (dW_hh above all: its split parts are summed in a fixed order)?"""
    again = bwd(*bargs)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, again))


def bound(bytes_, flops, dtype, peak=None):
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = flops / (peak or PEAK_FLOPS[dtype])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- kernels B and C: the ragged page-table walk ------------------------------


def ragged_case(name, *, r, tq, h, hkv, dh=64, dtype=torch.float32,
                pos0=None, inactive=0, sentinel_tail=0, seed=0, int8=False):
    """One walk case: kernel B over float arenas, or kernel C (int8=True)
    over (s8, scale) arenas quantized from the same kind of values."""
    rs = np.random.RandomState(seed)
    max_pages = -(-MAX_LEN // PAGE)
    num_pages = max(r, SLOTS) * max_pages
    dev = "cuda"
    mk = lambda *s: torch.from_numpy(
        rs.standard_normal(s).astype(np.float32)).to(dev, dtype)
    q = mk(r, tq, h, dh)
    ka = mk(num_pages, PAGE, hkv, dh)
    va = mk(num_pages, PAGE, hkv, dh)
    if int8:
        ka, va = PA.kv_quantize(ka), PA.kv_quantize(va)
    pt = np.stack([rs.permutation(num_pages)[:max_pages]
                   for _ in range(r)]).astype(np.int32)
    if sentinel_tail:
        pt[:, -sentinel_tail:] = num_pages
    if pos0 is None:
        pos0 = rs.randint(PROMPT, MAX_LEN - tq + 1, r)
    pos0 = np.broadcast_to(np.asarray(pos0, np.int32), (r,)).copy()
    active = np.ones(r, bool)
    if inactive:
        active[-inactive:] = False
    args = (q, ka, va, torch.from_numpy(pt).to(dev),
            torch.from_numpy(pos0).to(dev), torch.from_numpy(active).to(dev))
    kw = dict(page_size=PAGE, max_len=MAX_LEN)
    kind = "int8" if int8 else "float"
    before = RPA.device_launches[kind]
    got = RPA.ragged_kernel(*args, **kw)
    per_call = RPA.device_launches[kind] - before
    ref = RPA.ragged_reference(*args, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    same = bitwise_repeat(lambda *a: (RPA.ragged_kernel(*a, **kw),), args,
                          (got,))
    # the work this data needs: active rows attend keys <= pos0 + i, an
    # inactive row all max_len keys; a key is read once per KV head as
    # Dh values (s8 for C, with its f32 scale) for K and for V
    isz = q.element_size()
    keys_q = np.where(active[:, None],
                      np.minimum(pos0[:, None] + np.arange(tq) + 1, MAX_LEN),
                      MAX_LEN)                                # [R, TQ]
    keys_row = keys_q.max(axis=1)
    key_bytes = dh + 4 if int8 else dh * isz
    bytes_ = (2 * q.numel() * isz + 2 * keys_row.sum() * hkv * key_bytes
              + pt.nbytes + pos0.nbytes + active.nbytes)
    flops = 4 * dh * h * keys_q.sum()
    bound_ms, bound_by = bound(bytes_, flops, dtype)
    k_ms = time_ms(lambda: RPA.ragged_kernel(*args, **kw))
    p_ms = time_ms(lambda: RPA.ragged_reference(*args, **kw))
    # the split plan, and the device launches of one call (the walk, and
    # the combine where there are several splits)
    wp = RPA.walk_plan(r, tq, h, hkv, MAX_LEN, PAGE,
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count)
    ok = (err <= TOL[dtype] and same
          and per_call == (1 if wp.splits == 1 else 2))
    log(f"  {'C' if int8 else 'B'} {name:<22} {str(dtype)[6:]:<8} err "
        f"{err:.2e} (tol {TOL[dtype]:.0e}) kernel_ms {k_ms:.4f} plain_ms "
        f"{p_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) splits "
        f"{wp.splits} x {wp.span} keys, {wp.blocks(r, hkv)} blocks, "
        f"{per_call} device launches per call, bitwise {same} "
        f"{'ok' if ok else 'FAIL'}")
    return dict(name=name, err=err, ok=ok, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                tol=TOL[dtype], splits=wp.splits, span_keys=wp.span,
                blocks=wp.blocks(r, hkv), device_launches_per_call=per_call,
                bitwise=same)


def walk_resources_check():
    """Each instantiation of the split walk (B: float arenas, C: int8;
    f32 and bf16 queries; head_dim 64 and 128): its dynamic shared
    memory, registers, spills and blocks resident per SM, which must let
    2 x SMs blocks -- the plan's aim -- be resident at once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for (kind, dt, dh), (smem, regs, per_sm, spill) in \
            RPA.walk_resources().items():
        kern = "B" if kind == "float" else "C"
        log(f"  {kern} split_walk_kernel {dt} head_dim {dh}: {smem} bytes "
            f"of dynamic shared memory, {regs} registers, {spill} bytes "
            f"of spill, {per_sm} blocks per SM ({per_sm * sms} resident)")
        if per_sm < 2:
            raise Fail(f"{kern} {dt} head_dim {dh}: {per_sm} blocks per SM,"
                       f" fewer than the plan's 2 x {sms}")
        out[f"{kern}_{dt}_{dh}"] = dict(smem=smem, registers=regs,
                                        blocks_per_sm=per_sm, spill=spill)
    return out


# -- kernel A: flash attention forward ---------------------------------------


# above this many bytes of f32 scores the plain version is held against
# the kernel one batch row at a time
ROW_BY_ROW_BYTES = 4 << 30


def flash_case(name, *, b, t, h, d=64, dtype=torch.float32, causal=True,
               lens=None, window=None, seed=0, q_scale=1.0,
               row_relative=False):
    """One flash case: q, k, v N(0, 1) (q times q_scale) against the plain
    version, output within the dtype's tolerance and lse within f32's;
    both timed, beside SDPA where it computes the same function. The
    output's tolerance holds the max abs error, or with `row_relative`
    each output row's max abs error over that row's max |plain|: a long
    causal row averages thousands of values of v, so |o| falls to ~0.02
    there, the size of bf16's absolute tolerance."""
    rs = np.random.RandomState(seed)
    mk = lambda: torch.from_numpy(rs.standard_normal(
        (b, t, h, d)).astype(np.float32)).to("cuda", dtype)
    q, k, v = mk(), mk(), mk()
    if q_scale != 1.0:
        q = (q.float() * q_scale).to(dtype)
    lens_np = np.full(b, t) if lens is None else np.asarray(lens)
    lens_t = torch.from_numpy(lens_np.astype(np.int32)).to("cuda")
    kw = dict(causal=causal, window=window)
    o, lse = FA.flash_kernel(q, k, v, lens_t, **kw)
    row_by_row = b * h * t * t * 4 > ROW_BY_ROW_BYTES
    rows = [slice(i, i + 1) for i in range(b)] if row_by_row else [
        slice(0, b)]
    err = lse_err = row_err = 0.0
    lse_scale = 1.0
    for r in rows:
        o_ref, lse_ref = FA.flash_attention_reference(q[r], k[r], v[r],
                                                      lens_t[r], **kw)
        diff = (o[r].float() - o_ref.float()).abs()
        err = max(err, diff.max().item())
        if row_relative:
            scale = o_ref.float().abs().amax(dim=-1, keepdim=True)
            row_err = max(row_err, (diff / scale.clamp_min(1e-30)).max()
                          .item())
        del diff
        live = lse_ref > -1e29
        if live.any():
            lse_err = max(lse_err,
                          (lse[r] - lse_ref)[live].abs().max().item())
            lse_scale = max(lse_scale, lse_ref[live].abs().max().item())
        del o_ref, lse_ref
    torch.cuda.synchronize()
    # valid (query, key) pairs of this data, per batch row
    qpos = np.arange(t)[:, None]
    kpos = np.arange(t)[None, :]
    pairs = 0
    for n in lens_np:
        m = kpos < n
        if causal:
            m = m & (qpos >= kpos)
            if window is not None:
                m = m & (qpos - kpos < window)
        pairs += int(m.sum())
    isz = q.element_size()
    bytes_ = (2 * q.numel() * isz + 2 * int(lens_np.sum()) * h * d * isz
              + lse.numel() * 4 + lens_np.size * 4)
    flops = 4 * d * h * pairs
    bound_ms, bound_by = bound(
        bytes_, flops, dtype,
        PEAK_3XTF32 if dtype == torch.float32 else None)
    k_ms = time_ms(lambda: FA.flash_kernel(q, k, v, lens_t, **kw))
    r = rows[0]
    p_ms = time_ms(lambda: FA.flash_attention_reference(
        q[r], k[r], v[r], lens_t[r], **kw), iters=5 if row_by_row else 20)
    lib_ms = None
    if causal and window is None and (lens_np == t).all():
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
    tol = TOL[dtype]
    # lse is f32 in both versions: hold it to f32's tolerance, relative
    # to its own scale (log-sum-exps grow with the scores)
    held = row_err if row_relative else err
    ok = held <= tol and lse_err <= 1e-4 * lse_scale
    lib = "-" if lib_ms is None else f"{lib_ms:.4f}"
    plain = f"{p_ms:.4f}" + (f" (1 of {b} rows)" if row_by_row else "")
    rel = f" row_rel_err {row_err:.2e}" if row_relative else ""
    log(f"  A {name:<22} {str(dtype)[6:]:<8} err {err:.2e}{rel} lse_err "
        f"{lse_err:.2e} (tol {tol:.0e}) kernel_ms {k_ms:.4f} plain_ms "
        f"{plain} bound_ms {bound_ms:.4f} ({bound_by}) library_ms {lib} "
        f"{'ok' if ok else 'FAIL'}")
    out = dict(name=name, err=err, ok=ok, ms=k_ms, plain_ms=p_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
               tol=tol, lse_err=lse_err)
    if row_relative:
        out["row_rel_err"] = row_err
    return out


def flash_hmma_counts():
    """{instantiation: HMMA instructions} of each flash_fwd_kernel in the
    built library (`cuobjdump --dump-sass`): tensor-core products. Fails
    if an instantiation has none."""
    cuobjdump = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "--dump-sass", str(_cuda.library_path(
            "flash_attention"))], capture_output=True, text=True,
        timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                          fn)
            cur = None if m is None else (
                f"{'float32' if m.group(1) == 'f' else 'bfloat16'}, "
                f"D={m.group(2)}")
            if cur is not None:
                counts[cur] = 0
        elif cur is not None and "HMMA" in line:
            counts[cur] += 1
    log(f"  flash_fwd_kernel HMMA instructions (cuobjdump --dump-sass): "
        f"{counts}")
    if len(counts) != 4 or not all(counts.values()):
        raise Fail(f"flash_fwd_kernel: an instantiation without tensor-core "
                   f"products, or missing: {counts}")
    return counts


def kernels_phase():
    f32, bf16 = torch.float32, torch.bfloat16
    log("phase kernels: flash attention forward (A)")
    a = {
        "main_prefill_t128": flash_case("main_prefill_t128", b=1, t=128,
                                        h=8),
    }
    for dt in (f32, bf16):
        sfx = "_" + str(dt)[6:]
        a["key_lens" + sfx] = flash_case(
            "key_lens", b=4, t=128, h=8, dtype=dt, lens=[128, 100, 37, 1])
        a["causal_t2048" + sfx] = flash_case("causal_t2048", b=1, t=2048,
                                             h=8, dtype=dt)
        a["window" + sfx] = flash_case("window64_t512", b=2, t=512, h=8,
                                       dtype=dt, window=64, lens=[512, 300])
        a["hd128" + sfx] = flash_case("head_dim128", b=1, t=256, h=4,
                                      d=128, dtype=dt)
        a["no_valid_key" + sfx] = flash_case(
            "no_valid_key", b=2, t=64, h=2, dtype=dt, causal=False,
            lens=[0, 50])
    # bench_transformer_lm's attention (benchmarks/suite.py:331, bf16
    # policy at :759), and f32 scores of std 3 at f32's tolerance
    a["causal_t8192_bf16"] = flash_case("causal_t8192_b4", b=4, t=8192,
                                        h=8, dtype=bf16, row_relative=True)
    # the same shape in f32, as the LM train path feeds A under the bf16
    # policy (the dense layers' f32 biases promote their outputs), full
    # causal and in the LM's window of 1024 keys (tiles skipped before
    # the band); held row by row, as the bf16 case, at f32's tolerance
    a["causal_t8192_f32"] = flash_case("causal_t8192_b4", b=4, t=8192,
                                       h=8, dtype=f32, row_relative=True)
    a["window1024_t8192_f32"] = flash_case(
        "window1024_t8192_b4", b=4, t=8192, h=8, dtype=f32, window=1024,
        row_relative=True)
    a["scaled_scores_float32"] = flash_case("scores_std3_t512", b=2, t=512,
                                            h=8, q_scale=3.0, seed=1)
    log("phase kernels: ragged paged-attention walk (B)")
    b = {
        "main_decode": ragged_case("main_decode_r8", r=8, tq=1, h=8, hkv=8),
        "main_chunk": ragged_case("main_prefix_chunk_tq64", r=1, tq=64,
                                  h=8, hkv=8, pos0=SHARED),
    }
    for dt in (f32, bf16):
        sfx = "_" + str(dt)[6:]
        b["decode" + sfx] = ragged_case("decode_r8", r=8, tq=1, h=8, hkv=8,
                                        dtype=dt, seed=1)
        b["chunk" + sfx] = ragged_case("prefix_chunk_tq100", r=1, tq=100,
                                       h=8, hkv=8, dtype=dt, pos0=SHARED)
        b["gqa" + sfx] = ragged_case("gqa_h8_hkv2", r=8, tq=4, h=8, hkv=2,
                                     dtype=dt, seed=2)
        b["sentinel" + sfx] = ragged_case(
            "sentinels_inactive", r=8, tq=3, h=8, hkv=4, dtype=dt,
            inactive=2, sentinel_tail=3, seed=3, pos0=[0, 9, 40, 100, 150,
                                                        170, 200, 250][:8])
        b["hd128" + sfx] = ragged_case("head_dim128", r=4, tq=2, h=4,
                                       hkv=2, dh=128, dtype=dt, seed=4)
        # rows that reach max_len (every split holds live keys), and
        # inactive rows whose uniform mean of V spans every split
        b["max_len" + sfx] = ragged_case("decode_pos0_255", r=8, tq=1, h=8,
                                         hkv=8, dtype=dt, pos0=MAX_LEN - 1,
                                         seed=6)
        b["inactive" + sfx] = ragged_case(
            "decode_inactive_splits", r=8, tq=1, h=8, hkv=8, dtype=dt,
            inactive=4, seed=7, pos0=[3, 17, 40, 255, 100, 130, 64, 200])
    log("phase kernels: ragged paged-attention walk, int8 arenas (C)")
    c = {
        "main_decode": ragged_case("main_decode_r8", r=8, tq=1, h=8, hkv=8,
                                   int8=True),
        "main_chunk": ragged_case("main_prefix_chunk_tq64", r=1, tq=64,
                                  h=8, hkv=8, pos0=SHARED, int8=True),
    }
    for dt in (f32, bf16):
        sfx = "_" + str(dt)[6:]
        c["verify" + sfx] = ragged_case("verify_window_tq5", r=8, tq=5,
                                        h=8, hkv=8, dtype=dt, seed=5,
                                        int8=True)
        c["gqa" + sfx] = ragged_case("gqa_h8_hkv2", r=8, tq=4, h=8, hkv=2,
                                     dtype=dt, seed=2, int8=True)
        c["sentinel" + sfx] = ragged_case(
            "sentinels_inactive", r=8, tq=3, h=8, hkv=4, dtype=dt,
            inactive=2, sentinel_tail=3, seed=3, pos0=[0, 9, 40, 100, 150,
                                                        170, 200, 250],
            int8=True)
        c["hd128" + sfx] = ragged_case("head_dim128", r=4, tq=2, h=4,
                                       hkv=2, dh=128, dtype=dt, seed=4,
                                       int8=True)
    c["decode_bf16"] = ragged_case("decode_r8", r=8, tq=1, h=8, hkv=8,
                                   dtype=bf16, seed=1, int8=True)
    # rows that reach max_len (every split holds live keys), and inactive
    # rows whose uniform mean of V spans every split
    for dt in (f32, bf16):
        sfx = "_" + str(dt)[6:]
        c["max_len" + sfx] = ragged_case("decode_pos0_255", r=8, tq=1, h=8,
                                         hkv=8, dtype=dt, pos0=MAX_LEN - 1,
                                         seed=6, int8=True)
        c["inactive" + sfx] = ragged_case(
            "decode_inactive_splits", r=8, tq=1, h=8, hkv=8, dtype=dt,
            inactive=4, seed=7, pos0=[3, 17, 40, 255, 100, 130, 64, 200],
            int8=True)
    c["chunk_bf16"] = ragged_case("prefix_chunk_tq100", r=1, tq=100, h=8,
                                  hkv=8, dtype=bf16, pos0=SHARED, int8=True)
    bad = [f"{n}:{k}" for n, d in (("A", a), ("B", b), ("C", c))
           for k, v in d.items() if not v["ok"]]
    if bad:
        raise Fail(f"kernel disagrees with its plain version: {bad}")
    return a, b, c


# -- kernels D and E: the fused LSTM time loop ---------------------------------


def abs_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def rel_err(got, ref):
    """max |got - ref| over max |ref|: the LSTM cases' error measure (dW
    sums T*B terms, so its error is relative to its scale)."""
    return abs_err(got, ref) / max(ref.float().abs().max().item(), 1e-30)


def lstm_case_inputs(*, t, b, h, dtype, lengths, reverse, initial, seed):
    """x_proj [T, B, 4H] N(0, 1), w_hh [H, 4H] uniform(+-1/sqrt(H)) (the
    initializer's), both in `dtype`; h0/c0 zero or N(0, 0.25); bounds
    from lengths uniform in [T/2, T] (or full)."""
    rs = np.random.RandomState(seed)
    dev = "cuda"
    xp = torch.from_numpy(rs.standard_normal((t, b, 4 * h)).astype(
        np.float32)).to(dev, dtype)
    lim = 1.0 / np.sqrt(h)
    w = torch.from_numpy(rs.uniform(-lim, lim, (h, 4 * h)).astype(
        np.float32)).to(dev, dtype)
    st = lambda: torch.from_numpy(
        (0.5 * rs.standard_normal((b, h))).astype(np.float32)).to(dev)
    h0, c0 = (st(), st()) if initial else (
        torch.zeros(b, h, device=dev), torch.zeros(b, h, device=dev))
    lens = rs.randint(t // 2, t + 1, b) if lengths else np.full(b, t)
    bounds = FL.make_bounds(b, t, torch.from_numpy(lens).to(dev) if lengths
                            else None, reverse, device=dev)
    return (xp, w, h0, c0, bounds), lens


def cudnn_ms(rnn, t, b, gates):
    """A cuDNN torch.nn recurrent module (TF32 off) on [T, B, F], full
    lengths: (training forward ms, backward ms, input projection ms).
    cuDNN also does the input projection, which the port leaves to
    torch.matmul: its product [T*B, F] x [F, gates*H] is timed on its
    own."""
    rnn = rnn.cuda()
    f, h = rnn.input_size, rnn.hidden_size
    x = torch.randn(t, b, f, device="cuda", requires_grad=True)
    fwd = time_ms(lambda: rnn(x))
    out, _ = rnn(x)
    g = torch.randn_like(out)
    wrt = [x] + list(rnn.parameters())
    bwd = time_ms(lambda: torch.autograd.grad(out, wrt, g,
                                              retain_graph=True))
    w_ih = torch.randn(f, gates * h, device="cuda")
    proj = time_ms(lambda: x.detach().view(t * b, f) @ w_ih)
    return fwd, bwd, proj


def cudnn_lstm_ms(t, b, h):
    """torch.nn.LSTM(h, h) on [T, B, H]; see cudnn_ms."""
    return cudnn_ms(torch.nn.LSTM(h, h), t, b, 4)


def lstm_case(name, *, t=LSTM_T, b=LSTM_B, h=LSTM_H, dtype=torch.float32,
              lengths=False, reverse=False, initial=False, seed=0,
              library=False):
    """Kernels D and E on one case against their plain versions. E gets
    the plain forward's hs/cs and random cotangents."""
    args, lens = lstm_case_inputs(t=t, b=b, h=h, dtype=dtype,
                                  lengths=lengths, reverse=reverse,
                                  initial=initial, seed=seed)
    xp, w = args[0], args[1]
    rs = np.random.RandomState(seed + 100)
    cot = lambda *s: torch.from_numpy(
        rs.standard_normal(s).astype(np.float32)).cuda()
    dhs, dhl, dcl = cot(t, b, h).to(dtype), cot(b, h), cot(b, h)
    before = FL.device_launches["fwd"]
    hs, cs = FL.lstm_forward_kernel(*args)
    d_ops = FL.device_launches["fwd"] - before
    hs_r, cs_r = FL.lstm_forward_reference(*args)
    bargs = args + (hs_r, cs_r, dhs, dhl, dcl)
    grads = FL.lstm_backward_kernel(*bargs)
    grads_r = FL.lstm_backward_reference(*bargs)
    torch.cuda.synchronize()
    same = bitwise_repeat(FL.lstm_backward_kernel, bargs, grads)
    d_same = bitwise_repeat(FL.lstm_forward_kernel, args, (hs, cs))
    d_pairs = ((hs, hs_r), (cs, cs_r))
    e_pairs = tuple(zip(grads, grads_r))
    d_err = max(rel_err(a, r) for a, r in d_pairs)
    e_err = max(rel_err(a, r) for a, r in e_pairs)
    d_abs = max(abs_err(a, r) for a, r in d_pairs)
    e_abs = max(abs_err(a, r) for a, r in e_pairs)
    # the work this data needs: products only on live (row, step) pairs;
    # each input read once, each output written once
    live = int(lens.sum())
    xsz, wsz = xp.element_size(), w.element_size()
    seq = t * b * h
    common = 4 * seq * xsz + 4 * h * h * wsz + 2 * b * h * 4 + b * 8
    fwd_bytes = common + seq * xsz + seq * 4                   # hs, cs
    bwd_bytes = (common + 2 * seq * xsz + seq * 4 + 2 * b * h * 4
                 + 4 * seq * xsz + 4 * h * h * 4 + 2 * b * h * 4)
    flops_step = 2 * h * 4 * h
    d_bound, d_by = bound(fwd_bytes, live * flops_step, w.dtype)
    e_bound, e_by = bound(bwd_bytes, 3 * live * flops_step, w.dtype)
    d_ms = time_ms(lambda: FL.lstm_forward_kernel(*args))
    e_ms = time_ms(lambda: FL.lstm_backward_kernel(*bargs))
    dp_ms = time_ms(lambda: FL.lstm_forward_reference(*args), iters=3,
                    warmup=1)
    ep_ms = time_ms(lambda: FL.lstm_backward_reference(*bargs), iters=3,
                    warmup=1)
    lib = cudnn_lstm_ms(t, b, h) if library else (None, None, None)
    phases = phase_ms(FL.lstm_backward_kernel, bargs) if library else None
    tol = TOL[dtype]
    out = {}
    for kern, err, a_err, ms, p_ms, b_ms, by, lib_ms in (
            ("D", d_err, d_abs, d_ms, dp_ms, d_bound, d_by, lib[0]),
            ("E", e_err, e_abs, e_ms, ep_ms, e_bound, e_by, lib[1])):
        ok = err <= tol and (same if kern == "E" else
                             d_same and d_ops == 2)
        lib_s = "-" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"  {kern} {name:<24} {str(dtype)[6:]:<8} rel_err {err:.2e} "
            f"(tol {tol:.0e}) kernel_ms {ms:.4f} plain_ms {p_ms:.4f} "
            f"bound_ms {b_ms:.4f} ({by}) library_ms {lib_s} "
            f"{'ok' if ok else 'FAIL'}")
        out[kern] = dict(name=name, err=a_err, rel_err=err, ok=ok, ms=ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                         library_ms=lib_ms, tol=tol)
    out["E"].update(bitwise=same, phases_ms=phases)
    out["D"].update(bitwise=d_same, device_launches_per_call=d_ops,
                    us_per_step=d_ms / t * 1e3)
    log(f"    D: {d_ms / t * 1e3:.2f} us per step, {d_ops} device "
        f"operations per call (counters' memset, loop); a second call is "
        f"bitwise equal (hs, cs): {d_same}")
    log(f"    E: a second call on the same inputs is bitwise equal "
        f"(dxp, dW_hh, dh0, dc0): {same}")
    if phases:
        log_phases("E", phases, e_ms, t)
    if library:
        log(f"    cuDNN torch.nn.LSTM({h}, {h}) T={t} B={b}: forward "
            f"{lib[0]:.4f} ms, backward {lib[1]:.4f} ms; its input "
            f"projection [{t * b}, {h}] x [{h}, {4 * h}] alone "
            f"{lib[2]:.4f} ms")
    return out


def lstm_kernels_phase():
    log("phase kernels: fused LSTM time loop, forward (D) and backward (E); "
        f"T={LSTM_T} B={LSTM_B} H={LSTM_H} unless named")
    cases = {
        "main": lstm_case("main_full_f32", library=True),
        "ragged": lstm_case("ragged_len50-100", lengths=True, seed=1),
        "reverse": lstm_case("reverse_ragged", lengths=True, reverse=True,
                             seed=2),
        "initial": lstm_case("nonzero_h0_c0", initial=True, seed=3),
        "h256": lstm_case("h256_b128", h=256, b=128, seed=4, library=True),
        "h1280": lstm_case("h1280_b64", h=1280, seed=5, library=True),
        "bf16": lstm_case("bf16_xproj_whh_ragged", dtype=torch.bfloat16,
                          lengths=True, seed=6),
    }
    bad = [f"{k}:{c}" for c, d in cases.items() for k, v in d.items()
           if not v["ok"]]
    if bad:
        raise Fail(f"LSTM kernel disagrees with its plain version: {bad}")
    return cases


# -- training the LSTM classifier ----------------------------------------------


def bench_lstm_model(impl):
    """bench_lstm's network: embedding -> 2 x LSTM -> mean over time ->
    fc(2). impl None: kernels D and E; "torch": their plain versions."""
    return NM.Sequential([
        NL.Embedding(LSTM_VOCAB, LSTM_H, name="emb"),
        NR.LSTM(LSTM_H, name="lstm1", impl=impl),
        NR.LSTM(LSTM_H, name="lstm2", impl=impl),
        NL.Lambda(lambda x: x.mean(dim=1), name="pool",
                  out_spec_fn=lambda s: NM.ShapeSpec(
                      (s.shape[0], s.shape[2]), s.dtype)),
        NL.Dense(2, name="fc"),
    ])


def ce_loss(logits, labels):
    return torch.mean(LS.softmax_cross_entropy(logits, labels))


def clone_state(st):
    copy = lambda tree: tree_map(lambda t: t.clone(), tree)
    return TrainState(copy(st.params), copy(st.model_state),
                      copy(st.opt_state), st.step.clone())


def grad_rel_err(ga, gb):
    return max(rel_err(a, b) for a, b in zip(tree_leaves(ga),
                                             tree_leaves(gb)))


def timed_train(trainer, state, batches):
    """TRAIN_STEPS steps through Trainer.train with the launch counts set
    to 0 just before: (state, losses, wall seconds, (D, E) launches, (D,
    E) device launches)."""
    events = []
    torch.cuda.synchronize()
    FL.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.train(
        state, lambda: (batches[i % len(batches)]
                        for i in range(TRAIN_STEPS)),
        event_handler=events.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = (FL.launch_counts["fwd"], FL.launch_counts["bwd"])
    losses = [e.cost for e in events if isinstance(e, EV.EndIteration)]
    return state, losses, wall, launched, (FL.device_launches["fwd"],
                                           FL.device_launches["bwd"])


def train_phase():
    """The bench_lstm classifier at its width through the port's Trainer,
    on kernels D and E and then on their plain versions from the same
    weights: first-step gradients, every step's loss, launches."""
    log(f"phase train: bench_lstm classifier, vocab {LSTM_VOCAB}, emb = "
        f"hidden = {LSTM_H}, 2 x LSTM, mean pool, Dense(2), adam 1e-3, "
        f"B={LSTM_B} T={LSTM_T}, {TRAIN_STEPS} steps over {TRAIN_BATCHES} "
        f"batches")
    rs = np.random.RandomState(3)
    batches = [(rs.randint(0, LSTM_VOCAB, (LSTM_B, LSTM_T)).astype(np.int32),
                rs.randint(0, 2, LSTM_B).astype(np.int32))
               for _ in range(TRAIN_BATCHES)]
    spec = NM.ShapeSpec((LSTM_B, LSTM_T), torch.int32)
    kern = Trainer(bench_lstm_model(None), ce_loss, OPT.adam(1e-3), seed=0)
    plain = Trainer(bench_lstm_model("torch"), ce_loss, OPT.adam(1e-3),
                    seed=0)
    state0 = kern.init_state(spec)

    x, y = (torch.from_numpy(a).cuda() for a in batches[0])
    _, _, gk, _ = loss_and_grads(kern.model, ce_loss, state0.params, {},
                                 None, (x,), (y,))
    _, _, gp, _ = loss_and_grads(plain.model, ce_loss, state0.params, {},
                                 None, (x,), (y,))
    g_err = grad_rel_err(gk, gp)
    log(f"  first-step gradients, kernel vs plain path: max rel err "
        f"{g_err:.2e} (tol {GRAD_RTOL:.0e})")
    if g_err > GRAD_RTOL:
        raise Fail(f"train: first-step gradients differ: {g_err:.2e}")

    for tr in (kern, plain):     # warm the allocator and cuBLAS
        tr.train(clone_state(state0), lambda: batches[:1])
    _, k_loss, k_wall, k_launch, k_dev = timed_train(
        kern, clone_state(state0), batches)
    _, p_loss, p_wall, p_launch, p_dev = timed_train(
        plain, clone_state(state0), batches)
    tokens = TRAIN_STEPS * LSTM_B * LSTM_T
    out = dict(steps=TRAIN_STEPS, kernel_ms_per_step=1e3 * k_wall /
               TRAIN_STEPS, kernel_tok_s=tokens / k_wall,
               plain_ms_per_step=1e3 * p_wall / TRAIN_STEPS,
               plain_tok_s=tokens / p_wall, grad_rel_err=g_err,
               losses=k_loss, plain_losses=p_loss,
               launches={"D": k_launch[0], "E": k_launch[1]},
               device_launches={"D": k_dev[0], "E": k_dev[1]})
    log(f"  kernel path: {out['kernel_ms_per_step']:.3f} ms/step = "
        f"{out['kernel_tok_s']:.1f} tokens/s; launches D {k_launch[0]} "
        f"({k_dev[0]} device operations), E {k_launch[1]} ({k_dev[1]} "
        f"device launches); losses {['%.6f' % v for v in k_loss]}")
    log(f"  plain path:  {out['plain_ms_per_step']:.3f} ms/step = "
        f"{out['plain_tok_s']:.1f} tokens/s; launches {p_launch}; losses "
        f"{['%.6f' % v for v in p_loss]}")
    want = (2 * TRAIN_STEPS, 2 * TRAIN_STEPS)
    if k_launch != want:
        raise Fail(f"train: (D, E) launched {k_launch} times, want {want} "
                   f"(2 of each per step)")
    if k_dev[0] != 2 * k_launch[0]:
        raise Fail(f"train: {k_launch[0]} D calls made {k_dev[0]} device "
                   f"operations, not 2 each (memset, loop)")
    if k_dev[1] < 3 * k_launch[1]:
        raise Fail(f"train: {k_launch[1]} E calls made {k_dev[1]} device "
                   f"launches, fewer than their three phases")
    if p_launch != (0, 0) or any(p_dev):
        raise Fail(f"train: the plain path launched kernels: {p_launch}, "
                   f"{p_dev} device launches of D and E")
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss))
    out["loss_rel_err"] = rel
    log(f"  losses agree to {rel:.2e} relative (tol {LOSS_RTOL:.0e})")
    if len(k_loss) != TRAIN_STEPS or not all(np.isfinite(k_loss)) or \
            rel > LOSS_RTOL:
        raise Fail(f"train: kernel and plain losses differ: {rel:.2e}")
    return out


def ragged_phase():
    """text_lstm at the same width (embed 512, hidden 512, max pool) on
    lengths uniform in [50, 100]: one forward and backward on kernels D
    and E, its gradients held against the plain path's."""
    log("phase ragged: text_lstm, embed = hidden = 512, max pool, B=64, "
        "T=100, lengths uniform in [50, 100]")
    rs = np.random.RandomState(4)
    params = TTL.init_params(rs, LSTM_VOCAB, embed_dim=LSTM_H,
                             hidden=LSTM_H, device="cuda")
    tokens = torch.from_numpy(rs.randint(0, LSTM_VOCAB, (LSTM_B, LSTM_T))
                              .astype(np.int32)).cuda()
    lens = torch.from_numpy(rs.randint(LSTM_T // 2, LSTM_T + 1,
                                      LSTM_B)).cuda()
    labels = torch.from_numpy(rs.randint(0, 2, LSTM_B)).cuda()
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def grads(impl):
        logits = TTL.apply(params, tokens, lens, pool="max", impl=impl)
        loss = ce_loss(logits, labels)
        return loss.item(), torch.autograd.grad(loss, leaves)

    torch.cuda.synchronize()
    FL.reset_launch_counts()
    k_loss, gk = grads(None)
    launched = (FL.launch_counts["fwd"], FL.launch_counts["bwd"])
    p_loss, gp = grads("torch")
    err = grad_rel_err(gk, gp)
    log(f"  loss kernel {k_loss:.6f} plain {p_loss:.6f}; gradients max rel "
        f"err {err:.2e} (tol {GRAD_RTOL:.0e}); launches D {launched[0]}, "
        f"E {launched[1]}")
    if launched != (2, 2):
        raise Fail(f"ragged: (D, E) launched {launched} times, want (2, 2)")
    if err > GRAD_RTOL or abs(k_loss - p_loss) > LOSS_RTOL * abs(p_loss):
        raise Fail(f"ragged: kernel and plain paths differ: grads {err:.2e}")
    return dict(loss=k_loss, plain_loss=p_loss, grad_rel_err=err,
                launches={"D": launched[0], "E": launched[1]})


# -- kernels F, G (GRU) and H, I (tanh RNN): the other fused time loops -------

# (forward, plain forward, backward, plain backward, gates, products per
# live step in the backward, does the backward read x_proj, the
# backward's phases, the wrappers' device-operation counts)
GRU_LOOP = (FG.gru_forward_kernel, FG.gru_forward_reference,
            FG.gru_backward_kernel, FG.gru_backward_reference, 3, 3, True,
            PHASES, FG.device_launches)
RNN_LOOP = (FR.rnn_forward_kernel, FR.rnn_forward_reference,
            FR.rnn_backward_kernel, FR.rnn_backward_reference, 1, 2, False,
            ("loop", "dw"), FR.device_launches)


def time_loop_case(loop, names, name, *, t, b, h, dtype=torch.float32,
                   lengths=False, reverse=False, initial=False, seed=0,
                   library=None):
    """One GRU or RNN time-loop case: the forward and backward kernels
    against their plain versions, the backward on the plain forward's hs
    and random cotangents. x_proj [T, B, gates*H] N(0, 1) and w_hh
    uniform(+-1/sqrt(H)) in `dtype`, h0 zero or N(0, 0.25), lengths
    uniform in [T/2, T] (or full). `library` is (cuDNN module, its input
    width), timed with cudnn_ms. The phased backward (G: three phases,
    I: two) must also repeat its outputs bit for bit, and its phases are
    timed beside cuDNN. The forward (F, H: the forward loop of
    time_loop.cuh) must repeat hs bit for bit and make 2 device
    operations per call (its counters' memset, the loop)."""
    (fwd_k, fwd_r, bwd_k, bwd_r, gates, bwd_products, bwd_xp, phase_set,
     device) = loop
    rs = np.random.RandomState(seed)
    dev = "cuda"
    xp = torch.from_numpy(rs.standard_normal((t, b, gates * h)).astype(
        np.float32)).to(dev, dtype)
    lim = 1.0 / np.sqrt(h)
    w = torch.from_numpy(rs.uniform(-lim, lim, (h, gates * h)).astype(
        np.float32)).to(dev, dtype)
    h0 = (torch.from_numpy((0.5 * rs.standard_normal((b, h))).astype(
        np.float32)).to(dev) if initial else torch.zeros(b, h, device=dev))
    lens = rs.randint(t // 2, t + 1, b) if lengths else np.full(b, t)
    bounds = FG.make_bounds(b, t, torch.from_numpy(lens).to(dev)
                            if lengths else None, reverse, device=dev)
    args = (xp, w, h0, bounds)
    cot = np.random.RandomState(seed + 100)
    dhs = torch.from_numpy(cot.standard_normal((t, b, h)).astype(
        np.float32)).to(dev)
    dhl = torch.from_numpy(cot.standard_normal((b, h)).astype(
        np.float32)).to(dev)
    before = device["fwd"]
    hs = fwd_k(*args)
    d_ops = device["fwd"] - before
    hs_r = fwd_r(*args)
    bargs = args + (hs_r, dhs, dhl)
    grads = bwd_k(*bargs)
    grads_r = bwd_r(*bargs)
    torch.cuda.synchronize()
    same = bitwise_repeat(bwd_k, bargs, grads)
    # the forward too (F and H, on the forward loop, must repeat)
    fwd_same = bitwise_repeat(lambda *a: (fwd_k(*a),), args, (hs,))
    pairs = {names[0]: ((hs, hs_r),), names[1]: tuple(zip(grads, grads_r))}
    # the work this data needs: products only on live (row, step) pairs;
    # each input read once, each output written once
    live = int(lens.sum())
    xsz, wsz = xp.element_size(), w.element_size()
    seq, state = t * b * h, b * h * 4
    common = gates * h * h * wsz + state + b * 8          # w_hh, h0, bounds
    fwd_bytes = common + gates * seq * xsz + seq * 4      # x_proj; hs
    bwd_bytes = (common + (gates * seq * xsz if bwd_xp else 0)
                 + 2 * seq * 4 + state                    # hs, dhs, dh_last
                 + gates * seq * xsz + gates * h * h * 4 + state)
    flops = live * 2 * h * gates * h
    bounds_ms = {names[0]: bound(fwd_bytes, flops, w.dtype),
                 names[1]: bound(bwd_bytes, bwd_products * flops, w.dtype)}
    ms = {names[0]: time_ms(lambda: fwd_k(*args)),
          names[1]: time_ms(lambda: bwd_k(*bargs))}
    plain = {names[0]: time_ms(lambda: fwd_r(*args), iters=3, warmup=1),
             names[1]: time_ms(lambda: bwd_r(*bargs), iters=3, warmup=1)}
    lib = (None, None, None)
    if library is not None:
        module, width = library
        lib = cudnn_ms(module, t, b, gates)
    phases = (phase_ms(bwd_k, bargs, phase_set) if library is not None
              else None)
    tol = TOL[dtype]
    out = {}
    for kern, lib_ms in zip(names, lib[:2]):
        err = max(rel_err(a, r) for a, r in pairs[kern])
        ok = err <= tol and (same if kern == names[1] else
                             fwd_same and d_ops == 2)
        b_ms, by = bounds_ms[kern]
        lib_s = "-" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"  {kern} {name:<24} {str(dtype)[6:]:<8} rel_err {err:.2e} "
            f"(tol {tol:.0e}) kernel_ms {ms[kern]:.4f} plain_ms "
            f"{plain[kern]:.4f} bound_ms {b_ms:.4f} ({by}) library_ms "
            f"{lib_s} {'ok' if ok else 'FAIL'}")
        out[kern] = dict(name=name, err=max(abs_err(a, r)
                                            for a, r in pairs[kern]),
                         rel_err=err, ok=ok, ms=ms[kern],
                         plain_ms=plain[kern], bound_ms=b_ms, bound_by=by,
                         library_ms=lib_ms, tol=tol)
    out[names[1]].update(bitwise=same, phases_ms=phases)
    out[names[0]].update(bitwise=fwd_same, device_launches_per_call=d_ops,
                         us_per_step=ms[names[0]] / t * 1e3)
    log(f"    {names[0]}: {ms[names[0]] / t * 1e3:.2f} us per step, {d_ops} "
        f"device operations per call (counters' memset, loop); a second "
        f"call on the same inputs is bitwise equal (hs): {fwd_same}; "
        f"{names[1]}: (dxp, dW_hh, dh0): {same}")
    if phases:
        log_phases(names[1], phases, ms[names[1]], t)
    if library is not None:
        log(f"    cuDNN {type(module).__name__}({width}, {h}) T={t} B={b}: "
            f"forward {lib[0]:.4f} ms, backward {lib[1]:.4f} ms; its input "
            f"projection [{t * b}, {width}] x [{width}, {gates * h}] alone "
            f"{lib[2]:.4f} ms")
    return out


def cudnn_gru():
    """cuDNN's GRU at the encoder's widths with b_hn = 0: PyTorch's
    n = tanh(xn + r * (h W_hn + b_hn)) is then the port's n, in the same
    r, z, n order."""
    gru = torch.nn.GRU(S2S_EMBED, S2S_H)
    with torch.no_grad():
        gru.bias_hh_l0.zero_()
    return gru, S2S_EMBED


def gru_rnn_kernels_phase():
    bf16 = torch.bfloat16
    log("phase kernels: fused GRU time loop, forward (F) and backward (G); "
        f"T={S2S_LEN} B={S2S_B} H={S2S_H} (the seq2seq encoder's)")
    kw = dict(t=S2S_LEN, b=S2S_B, h=S2S_H)
    gru = {
        "main": time_loop_case(GRU_LOOP, "FG", "main_full_f32",
                               library=cudnn_gru(), **kw),
        "ragged": time_loop_case(GRU_LOOP, "FG", "ragged_len15-30",
                                 lengths=True, seed=1, **kw),
        "reverse": time_loop_case(GRU_LOOP, "FG", "reverse_ragged",
                                  lengths=True, reverse=True, seed=2, **kw),
        "initial": time_loop_case(GRU_LOOP, "FG", "nonzero_h0", initial=True,
                                  seed=3, **kw),
        "bf16": time_loop_case(GRU_LOOP, "FG", "bf16_xproj_whh_ragged",
                               dtype=bf16, lengths=True, seed=4, **kw),
    }
    log("phase kernels: fused tanh-RNN time loop, forward (H) and backward "
        f"(I); T={RNN_T} B={RNN_B} H={RNN_H}")
    kw = dict(t=RNN_T, b=RNN_B, h=RNN_H)
    rnn = {
        "main": time_loop_case(
            RNN_LOOP, "HI", "main_full_f32", library=(torch.nn.RNN(
                RNN_H, RNN_H, nonlinearity="tanh"), RNN_H), **kw),
        "ragged": time_loop_case(RNN_LOOP, "HI", "ragged_len50-100",
                                 lengths=True, seed=5, **kw),
        "reverse": time_loop_case(RNN_LOOP, "HI", "reverse_ragged",
                                  lengths=True, reverse=True, seed=6, **kw),
        "initial": time_loop_case(RNN_LOOP, "HI", "nonzero_h0", initial=True,
                                  seed=8, **kw),
        "bf16": time_loop_case(RNN_LOOP, "HI", "bf16_xproj_whh_ragged",
                               dtype=bf16, lengths=True, initial=True,
                               seed=7, **kw),
    }
    bad = [f"{k}:{c}" for d in (gru, rnn) for c, case in d.items()
           for k, v in case.items() if not v["ok"]]
    if bad:
        raise Fail(f"GRU/RNN kernel disagrees with its plain version: {bad}")
    return gru, rnn


# E, G and I at shapes of their loop's other grids: w_hh's rows read
# from global memory (H >= 1536; I's from H=2816) and several pairs per
# thread (wide H or B); (kernel, name, T, B, H, dtype, w_hh's dtype where
# it differs), T cut to keep the plain versions short
WIDE_CASES = (
    ("E", "h1536_b64_l2_rows", 20, 64, 1536, torch.float32),
    ("E", "h2048_b64_l2_rows_2pairs", 20, 64, 2048, torch.float32),
    ("E", "h2048_b64_bf16", 20, 64, 2048, torch.bfloat16),
    ("E", "h4096_b64_l2_rows_4pairs", 10, 64, 4096, torch.float32),
    ("E", "b256_h512_2pairs", 40, 256, 512, torch.float32),
    ("E", "b200_h1024_4pairs", 20, 200, 1024, torch.float32),
    ("G", "h2048_b64_l2_rows_2pairs", 20, 64, 2048, torch.float32),
    ("G", "b128_h1024_bf16", 20, 128, 1024, torch.bfloat16),
    ("I", "h2048_b64_2pairs", 20, 64, 2048, torch.float32),
    ("I", "h4096_b64_l2_rows_bf16_xproj", 10, 64, 4096, torch.bfloat16,
     torch.float32),
    # F on the forward loop: gate columns read from w_hh^T through L2
    # (H >= 1536, refused by the one-launch F at B=64), several pairs per
    # thread, and the 32-row tiles of large batches
    ("F", "h1536_b64_l2_rows", 20, 64, 1536, torch.float32),
    ("F", "h2048_b64_l2_rows_4pairs", 20, 64, 2048, torch.float32),
    ("F", "h2048_b16_bf16", 20, 16, 2048, torch.bfloat16),
    ("F", "b128_h1024_bf16", 20, 128, 1024, torch.bfloat16),
    ("F", "b256_h1024_8pairs", 20, 256, 1024, torch.float32),
    # D on the forward loop: its four gate columns read from w_hh^T
    # through L2 (H >= 1536), in f32 and bf16, and the 32-row tiles of a
    # large batch
    ("D", "h1536_b64_l2_rows", 20, 64, 1536, torch.float32),
    ("D", "h2048_b64_l2_rows_4pairs", 20, 64, 2048, torch.float32),
    ("D", "h2048_b64_l2_rows_bf16", 20, 64, 2048, torch.bfloat16),
    ("D", "b256_h1024_8pairs", 20, 256, 1024, torch.float32),
    # H on the forward loop, one gate column: 4 pairs per thread,
    # w_hh's columns read from w_hh^T through L2 from H=2816 (B=64; the
    # one-launch H refused H >= 2816 there), and B=100, H=2560, which
    # only the one-gate bounds of the 2 x 4 and 1 x 8 tiles take (8
    # pairs a thread, from L2)
    ("H", "h2048_b64_4pairs", 20, 64, 2048, torch.float32),
    ("H", "h4096_b64_l2_rows_4pairs", 10, 64, 4096, torch.float32),
    ("H", "h2816_b64_l2_rows", 20, 64, 2816, torch.float32),
    ("H", "h2048_b64_bf16", 20, 64, 2048, torch.bfloat16),
    ("H", "b256_h1024_4pairs", 20, 256, 1024, torch.float32),
    ("H", "b100_h2560_one_gate_bound", 20, 100, 2560, torch.float32),
)


def wide_case(kern, name, t, b, h, dtype, w_dtype=None, *, seed):
    """E, G or I alone against its plain version on the plain forward's
    outputs, with ragged lengths, nonzero initial state and random
    cotangents (D, F, H: the forward alone on the same inputs); a second
    call must repeat every output bit for bit. Its
    device time (5 calls) is logged beside the grid it ran. x_proj (and
    w_hh, unless w_dtype is given) in `dtype`."""
    rs = np.random.RandomState(seed + 100)
    cot = lambda *sh: torch.from_numpy(
        rs.standard_normal(sh).astype(np.float32)).cuda()
    if kern in "DE":
        args, _ = lstm_case_inputs(t=t, b=b, h=h, dtype=dtype, lengths=True,
                                   reverse=False, initial=True, seed=seed)
        limits = FL.device_limits(args[0].device)
        if kern == "D":
            bargs = args
            bwd_k, bwd_r = FL.lstm_forward_kernel, FL.lstm_forward_reference
            geo = FL.geometry(b, h, *limits)
        else:
            bargs = args + FL.lstm_forward_reference(*args) + (
                cot(t, b, h).to(dtype), cot(b, h), cot(b, h))
            bwd_k, bwd_r = (FL.lstm_backward_kernel,
                            FL.lstm_backward_reference)
            geo = FL.backward_geometry(b, h, *limits)
    else:
        gates = 3 if kern in "FG" else 1
        mod = FG if kern in "FG" else FR
        fwd_k = (FG.gru_forward_kernel if kern in "FG"
                 else FR.rnn_forward_kernel)
        gr = np.random.RandomState(seed)
        lim = 1.0 / np.sqrt(h)
        xp = torch.from_numpy(gr.standard_normal((t, b, gates * h)).astype(
            np.float32)).to("cuda", dtype)
        w = torch.from_numpy(gr.uniform(-lim, lim, (h, gates * h)).astype(
            np.float32)).to("cuda", w_dtype or dtype)
        h0 = torch.from_numpy((0.5 * gr.standard_normal((b, h))).astype(
            np.float32)).cuda()
        lens = torch.from_numpy(gr.randint(t // 2, t + 1, b)).cuda()
        args = (xp, w, h0, FG.make_bounds(b, t, lens, False, device="cuda"))
        fwd_r = (FG.gru_forward_reference if kern in "FG"
                 else FR.rnn_forward_reference)
        if kern in "FH":
            # the forward alone: its call and plain version take args
            bargs = args
            bwd_k, bwd_r = (lambda *a: (fwd_k(*a),),
                            lambda *a: (fwd_r(*a),))
            geo = mod.geometry(b, h, *mod._limits(xp.device))
        else:
            bargs = args + (fwd_r(*args), cot(t, b, h), cot(b, h))
            bwd_k, bwd_r = ((FG.gru_backward_kernel,
                             FG.gru_backward_reference) if kern == "G" else
                            (FR.rnn_backward_kernel,
                             FR.rnn_backward_reference))
            geo = mod.backward_geometry(b, h, *mod._limits(xp.device))
    got = bwd_k(*bargs)
    ref = bwd_r(*bargs)
    torch.cuda.synchronize()
    same = bitwise_repeat(bwd_k, bargs, got)
    err = max(rel_err(a, r) for a, r in zip(got, ref))
    ms = time_ms(lambda: bwd_k(*bargs), iters=5, warmup=1)
    tol = max(TOL[dtype], TOL[w_dtype or dtype])
    ok = err <= tol and same
    label = str(dtype)[6:] + (f"/{str(w_dtype)[6:]}" if w_dtype else "")
    log(f"  {kern} {name:<28} {label:<8} T={t} rel_err {err:.2e} "
        f"(tol {tol:.0e}) bitwise {same} kernel_ms {ms:.4f}; grid "
        f"{geo.row_groups} x {geo.unit_groups}, hb {geo.hb}, br {geo.br}, "
        f"{geo.rep} pairs/thread, w_hh rows "
        f"{'resident' if geo.resident else 'from L2'} "
        f"{'ok' if ok else 'FAIL'}")
    return dict(name=name, kernel=kern, t=t, b=b, h=h, dtype=label,
                rel_err=err, bitwise=same, ms=ms,
                rep=geo.rep, resident=geo.resident, ok=ok)


def wide_phase():
    log("phase kernels: E, G, I, F, D and H on their loops' other grids "
        "(w_hh's rows read from L2, several pairs per thread), ragged, "
        "nonzero initial state")
    cases = [wide_case(*c, seed=20 + i) for i, c in enumerate(WIDE_CASES)]
    bad = [f"{c['kernel']}:{c['name']}" for c in cases if not c["ok"]]
    if bad:
        raise Fail(f"E/G/I/F/D/H disagree with their plain versions: "
                   f"{bad}")
    return cases


# -- training and decoding seq2seq-attention NMT -------------------------------


def time_loop_counts():
    return {"F": FG.launch_counts["fwd"], "G": FG.launch_counts["bwd"],
            "H": FR.launch_counts["fwd"], "I": FR.launch_counts["bwd"]}


def reset_time_loop_counts():
    FG.reset_launch_counts()
    FR.reset_launch_counts()


def trainable(params):
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), params)


LEAF_FLOOR = 1e-6


def leaf_rel_errs(params, ga, gb):
    """(max rel err, one log line per leaf) of two gradient lists in
    tree_leaves(params) order. Each leaf's max abs error is taken over
    its own largest plain magnitude, floored at LEAF_FLOOR x the largest
    plain gradient of any leaf: at random init attention's w_dec has a
    gradient ~1e-9 of the others' (the softmax's shift invariance cancels
    it while tanh is near linear), so on its own scale it measures f32
    cancellation, not the kernels."""
    names = []
    tree_map_with_name(lambda n, _: names.append(n), params)
    top = max(b.abs().max().item() for b in gb)
    worst, lines = 0.0, []
    for n, a, b in zip(names, ga, gb):
        mag = b.abs().max().item()
        err = abs_err(a, b)
        rel = err / max(mag, LEAF_FLOOR * top, 1e-30)
        worst = max(worst, rel)
        lines.append(f"    {n:<16} max|plain| {mag:.3e} max abs err "
                     f"{err:.3e} rel {rel:.2e}")
    return worst, lines


def s2s_grads(params, batch, impl):
    """(loss, gradients in tree_leaves order) of seq2seq_attn.loss."""
    loss = TS.loss(params, *batch, impl=impl)
    return loss, torch.autograd.grad(loss, tree_leaves(params))


def s2s_train(params, batches, impl, steps):
    """`steps` hand-rolled steps (the bench's: gradients, then adam's
    update in place) from a copy of params: (params, losses, wall
    seconds, launches of F-I in this run, F's and G's device
    launches)."""
    params = trainable(params)
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params)
    losses = []
    torch.cuda.synchronize()
    reset_time_loop_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        loss, grads = s2s_grads(params, batches[i % len(batches)], impl)
        it = iter(grads)
        opt.update(tree_map(lambda _: next(it), params), opt_state, params,
                   torch.tensor(i, dtype=torch.int32, device="cuda"))
        losses.append(loss.detach())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (params, [v.item() for v in losses], wall, time_loop_counts(),
            {"F": FG.device_launches["fwd"], "G": FG.device_launches["bwd"]})


def seq2seq_phase():
    """seq2seq_attn at bench_seq2seq's width: 10 train steps on kernels F
    and G and then on their plain versions from the same weights; the
    first step's gradients, every loss, the launches."""
    log(f"phase seq2seq: seq2seq_attn, vocab {S2S_VOCAB}, embed {S2S_EMBED}, "
        f"hidden {S2S_H}, B={S2S_B}, src_len = tgt_len = {S2S_LEN}, lengths "
        f"uniform in [{S2S_LEN // 2}, {S2S_LEN}], adam 1e-3, {TRAIN_STEPS} "
        f"steps over {TRAIN_BATCHES} batches")
    rs = np.random.RandomState(5)
    params = TS.init_params(rs, S2S_VOCAB, S2S_VOCAB, embed_dim=S2S_EMBED,
                            hidden=S2S_H, device="cuda")
    cuda = lambda a: torch.from_numpy(a).cuda()
    shape, half = (S2S_B, S2S_LEN), S2S_LEN // 2
    batches = [(cuda(rs.randint(2, S2S_VOCAB, shape).astype(np.int32)),
                cuda(rs.randint(half, S2S_LEN + 1, S2S_B).astype(np.int32)),
                cuda(rs.randint(2, S2S_VOCAB, shape).astype(np.int32)),
                cuda(rs.randint(half, S2S_LEN + 1, S2S_B).astype(np.int32)))
               for _ in range(TRAIN_BATCHES)]

    p0 = trainable(params)
    _, gk = s2s_grads(p0, batches[0], None)
    _, gp = s2s_grads(p0, batches[0], "torch")
    g_err, table = leaf_rel_errs(p0, gk, gp)
    for line in table:
        log(line)
    log(f"  first-step gradients ({len(gk)} leaves), kernel vs plain path: "
        f"max rel err {g_err:.2e} (tol {GRAD_RTOL:.0e})")
    if g_err > GRAD_RTOL:
        raise Fail(f"seq2seq: first-step gradients differ: {g_err:.2e}")

    for impl in (None, "torch"):     # warm the allocator and cuBLAS
        s2s_train(params, batches, impl, 1)
    trained, k_loss, k_wall, k_launch, k_dev = s2s_train(
        params, batches, None, TRAIN_STEPS)
    _, p_loss, p_wall, p_launch, p_dev = s2s_train(params, batches, "torch",
                                                   TRAIN_STEPS)
    tokens = sum(int(batches[i % TRAIN_BATCHES][3].sum())
                 for i in range(TRAIN_STEPS))
    out = dict(steps=TRAIN_STEPS, tgt_tokens=tokens,
               kernel_ms_per_step=1e3 * k_wall / TRAIN_STEPS,
               kernel_tgt_tok_s=tokens / k_wall,
               plain_ms_per_step=1e3 * p_wall / TRAIN_STEPS,
               plain_tgt_tok_s=tokens / p_wall, grad_rel_err=g_err,
               losses=k_loss, plain_losses=p_loss, launches=k_launch,
               device_launches=k_dev)
    log(f"  kernel path: {out['kernel_ms_per_step']:.3f} ms/step = "
        f"{out['kernel_tgt_tok_s']:.1f} target tokens/s; launches "
        f"{k_launch} (device launches {k_dev}); losses "
        f"{['%.6f' % v for v in k_loss]}")
    log(f"  plain path:  {out['plain_ms_per_step']:.3f} ms/step = "
        f"{out['plain_tgt_tok_s']:.1f} target tokens/s; launches "
        f"{p_launch}; losses {['%.6f' % v for v in p_loss]}")
    want = dict(F=2 * TRAIN_STEPS, G=2 * TRAIN_STEPS, H=0, I=0)
    if k_launch != want:
        raise Fail(f"seq2seq: launched {k_launch}, want {want} (2 F and 2 G "
                   f"per step)")
    if k_dev["G"] < 3 * k_launch["G"]:
        raise Fail(f"seq2seq: {k_launch['G']} G calls made {k_dev['G']} "
                   f"device launches, fewer than their three phases")
    if k_dev["F"] != 2 * k_launch["F"]:
        raise Fail(f"seq2seq: {k_launch['F']} F calls made {k_dev['F']} "
                   f"device launches, not their counters' memset and loop")
    if any(p_launch.values()) or any(p_dev.values()):
        raise Fail(f"seq2seq: the plain path launched kernels: {p_launch}, "
                   f"device launches {p_dev}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss))
    out["loss_rel_err"] = rel
    log(f"  losses agree to {rel:.2e} relative (tol {LOSS_RTOL:.0e})")
    if len(k_loss) != TRAIN_STEPS or not all(np.isfinite(k_loss)) or \
            rel > LOSS_RTOL:
        raise Fail(f"seq2seq: kernel and plain losses differ: {rel:.2e}")
    return out, trained, batches[0]


def beam_gaps(params, src, lens):
    """Per source row, the smallest score gap among the K+1 best
    candidates of any step of the plain path's beam search (and among its
    final scores): where it is <= GAP_LIMIT the kernel path may pick
    another beam at a near tie."""
    k = GEN_BEAM
    enc_out, h0 = TS.encode(params, src, lens, impl="torch")
    mask = torch.arange(src.shape[1], device=src.device)[None] < lens[:, None]
    statics = (enc_out, TS.project_encoder(params, enc_out), mask)
    gaps = torch.full((src.shape[0],), float("inf"), device=src.device)

    def record(step, logits, st):
        b = st.scores.shape[0]
        log_p = torch.log_softmax(logits.float(), -1).reshape(b, k, -1)
        eos_only = torch.full_like(log_p[0, 0], -1e30)
        eos_only[0] = 0.0
        log_p = torch.where(st.finished[:, :, None], eos_only, log_p)
        top = torch.topk((st.scores[:, :, None] + log_p).reshape(b, -1),
                         k + 1).values
        live = top[:, :-1] > -1e29
        gap = torch.where(live, top[:, :-1] - top[:, 1:], float("inf"))
        gaps.copy_(torch.minimum(gaps, gap.min(dim=1).values))
        return logits

    _, scores, _ = TS.decoder_group(h0.shape[-1]).generate(
        params, embed_fn=lambda toks: params["tgt_embed"][toks.long()],
        batch_size=src.shape[0], vocab_size=params["out"]["kernel"].shape[1],
        max_len=GEN_MAX_LEN, bos_id=1, eos_id=0, beam_size=k,
        boots={"h": h0}, statics=statics, modify_logits_fn=record,
        greedy=False)
    final = (scores[:, :-1] - scores[:, 1:]).min(dim=1).values
    return torch.minimum(gaps, final).tolist()


def greedy_gap(params, src, lens, tokens, row, step):
    """The plain path's top-2 logit gap at greedy step `step` of `row`:
    the decoder teacher-forced on the plain path's own tokens."""
    bos = torch.ones_like(tokens[:, :1])
    tgt_in = torch.cat([bos, tokens[:, :-1]], dim=1)
    logits = TS.teacher_forced_logits(params, src, lens, tgt_in,
                                      impl="torch")
    top2 = torch.topk(logits[row, step], 2).values
    return (top2[0] - top2[1]).item()


def generation_phase(params, batch):
    """Beam (K=4) and greedy decoding of GEN_ROWS source rows with the
    trained weights, on the kernels and on the plain path."""
    log(f"phase generation: generate(beam_size={GEN_BEAM}, max_len="
        f"{GEN_MAX_LEN}) and greedy_generate on {GEN_ROWS} source rows of "
        f"the trained weights")
    params = tree_map(lambda t: t.detach(), params)
    src, lens = batch[0][:GEN_ROWS], batch[1][:GEN_ROWS]
    runs, launches, walls = {}, {}, {}
    for label, fn, impl in (
            ("beam", TS.generate, None), ("greedy", TS.greedy_generate, None),
            ("beam_plain", TS.generate, "torch"),
            ("greedy_plain", TS.greedy_generate, "torch")):
        kw = dict(beam_size=GEN_BEAM) if fn is TS.generate else {}
        with torch.no_grad():
            fn(params, src, lens, max_len=GEN_MAX_LEN, impl=impl, **kw)
            torch.cuda.synchronize()
            reset_time_loop_counts()
            t0 = time.perf_counter()
            runs[label] = fn(params, src, lens, max_len=GEN_MAX_LEN,
                             impl=impl, **kw)
            torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        launches[label] = time_loop_counts()
        launches[label]["F_device"] = FG.device_launches["fwd"]
        lengths = runs[label][-1]
        log(f"  {label}: {walls[label] * 1e3:.1f} ms, launches "
            f"{launches[label]}, mean length "
            f"{lengths.float().mean().item():.2f}")
    for label in ("beam", "greedy"):
        if launches[label] != dict(F=2, G=0, H=0, I=0, F_device=4):
            raise Fail(f"generation: {label} launched {launches[label]}, "
                       f"want 2 F (4 device launches) and no other")
        if any(launches[label + "_plain"].values()):
            raise Fail(f"generation: the plain path launched kernels: "
                       f"{launches[label + '_plain']}")
    out = dict(rows=GEN_ROWS, beam=GEN_BEAM, max_len=GEN_MAX_LEN,
               launches={k: launches[k] for k in ("beam", "greedy")},
               ms={k: 1e3 * v for k, v in walls.items()})

    tok, scores, blen = runs["beam"]
    ptok, pscores, plen = runs["beam_plain"]
    same = (tok == ptok).flatten(1).all(dim=1) & (blen == plen).all(dim=1)
    diff = [i for i in range(GEN_ROWS) if not bool(same[i])]
    if diff:
        gaps = beam_gaps(params, src, lens)
        for i in diff:
            log(f"  beam: row {i} differs; the plain search's smallest "
                f"candidate gap {gaps[i]:.3e}")
            if gaps[i] > GAP_LIMIT:
                raise Fail(f"generation: beam row {i} differs away from a "
                           f"near tie (gap {gaps[i]:.3e} > {GAP_LIMIT})")
    keep = same[:, None].expand_as(scores)
    s_err = ((scores - pscores).abs() / pscores.abs().clamp(min=1.0))[keep]
    s_err = s_err.max().item() if s_err.numel() else 0.0
    out.update(beam_rows_equal=GEN_ROWS - len(diff), beam_score_rel_err=s_err)
    log(f"  beam: tokens equal on {GEN_ROWS - len(diff)}/{GEN_ROWS} rows; "
        f"scores agree to {s_err:.2e} relative (tol {SCORE_RTOL:.0e})")
    if s_err > SCORE_RTOL:
        raise Fail(f"generation: beam scores differ: {s_err:.2e}")

    gtok, glen = runs["greedy"]
    pgtok, pglen = runs["greedy_plain"]
    same_g = 0
    for i in range(GEN_ROWS):
        d = (gtok[i] != pgtok[i]).nonzero()
        if not len(d):
            same_g += 1
            continue
        gap = greedy_gap(params, src, lens, pgtok, i, int(d[0]))
        log(f"  greedy: row {i}: first differing step {int(d[0])}, plain "
            f"top-2 logit gap {gap:.3e}")
        if gap > GAP_LIMIT:
            raise Fail(f"generation: greedy row {i} differs at a top-2 gap "
                       f"{gap:.3e} > {GAP_LIMIT}")
    out["greedy_rows_equal"] = same_g
    log(f"  greedy: tokens equal on {same_g}/{GEN_ROWS} rows")
    for t, ln in ((tok, blen), (gtok, glen)):
        if not bool(((t >= 0) & (t < S2S_VOCAB)).all()) or \
                not bool(((ln >= 1) & (ln <= GEN_MAX_LEN)).all()):
            raise Fail("generation: token or length out of range")
    if not bool(torch.isfinite(scores).all()):
        raise Fail("generation: beam scores are not finite")
    return out


def simple_rnn_phase():
    """simple_rnn at T=100, B=64, H=512 on lengths uniform in [50, 100]:
    one forward and backward on kernels H and I and on the plain path."""
    log(f"phase simple_rnn: T={RNN_T} B={RNN_B} F=H={RNN_H}, lengths "
        f"uniform in [{RNN_T // 2}, {RNN_T}]")
    rs = np.random.RandomState(6)
    params = tree_map(lambda t: t.cuda().requires_grad_(True),
                      RNN.init_rnn_params(rs, RNN_H, RNN_H))
    mk = lambda *s: torch.from_numpy(
        rs.standard_normal(s).astype(np.float32)).cuda()
    x = mk(RNN_B, RNN_T, RNN_H).requires_grad_(True)
    w_o, w_h = mk(RNN_B, RNN_T, RNN_H), mk(RNN_B, RNN_H)
    lens = torch.from_numpy(rs.randint(RNN_T // 2, RNN_T + 1, RNN_B)).cuda()
    wrt = [x] + tree_leaves(params)

    def grads(impl):
        out, fin = RNN.simple_rnn(params, x, lens, impl=impl)
        loss = torch.sum(out * w_o) + torch.sum(fin * w_h)
        return loss.item(), torch.autograd.grad(loss, wrt)

    torch.cuda.synchronize()
    reset_time_loop_counts()
    k_loss, gk = grads(None)
    launched = time_loop_counts()
    device = dict(FR.device_launches)
    p_loss, gp = grads("torch")
    plain_launched = time_loop_counts()
    err = max(rel_err(a, b) for a, b in zip(gk, gp))
    log(f"  loss kernel {k_loss:.6f} plain {p_loss:.6f}; gradients max rel "
        f"err {err:.2e} (tol {GRAD_RTOL:.0e}); launches {launched} (device "
        f"launches: H {device['fwd']}, I {device['bwd']})")
    if launched != dict(F=0, G=0, H=1, I=1):
        raise Fail(f"simple_rnn: launched {launched}, want one H and one I")
    if device["fwd"] != 2:
        raise Fail(f"simple_rnn: H made {device['fwd']} device launches, "
                   f"want its counters' memset and the forward loop")
    if device["bwd"] < 3:
        raise Fail(f"simple_rnn: I made {device['bwd']} device launches, "
                   f"want its counters' memset, serial loop and dW_hh")
    if plain_launched != launched or FR.device_launches != device:
        raise Fail("simple_rnn: the plain path launched kernels")
    if err > GRAD_RTOL or abs(k_loss - p_loss) > LOSS_RTOL * abs(p_loss):
        raise Fail(f"simple_rnn: kernel and plain paths differ: grads "
                   f"{err:.2e}")
    return dict(loss=k_loss, plain_loss=p_loss, grad_rel_err=err,
                launches={"H": launched["H"], "I": launched["I"]},
                device_launches={"H": device["fwd"], "I": device["bwd"]})


# -- the transformer LM's training path ----------------------------------------


def flash_bwd_case(name, *, b, t, h, d=64, dtype=torch.float32, causal=True,
                   lens=None, window=None, seed=0):
    """flash_attention's gradients on the card (kernel A forward, the
    ported backward) against torch.autograd through the plain version on
    the same tensors, with random cotangents; max abs error over max
    |plain| per gradient. Above ROW_BY_ROW_BYTES of f32 scores the plain
    gradients are taken one batch row at a time."""
    rs = np.random.RandomState(seed)
    mk = lambda: torch.from_numpy(rs.standard_normal(
        (b, t, h, d)).astype(np.float32)).to("cuda", dtype)
    q, k, v, g = mk(), mk(), mk(), mk()
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device="cuda")
    kw = dict(causal=causal, window=window)
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    FA.reset_launch_counts()
    got = torch.autograd.grad(FA.flash_attention(*qkv, key_lens=lens_t, **kw),
                              qkv, g)
    launched = FA.launch_counts["fwd"]
    if lens_t is None:
        lens_t = torch.full((b,), t, dtype=torch.int32, device="cuda")
    rows = ([slice(i, i + 1) for i in range(b)]
            if b * h * t * t * 4 > ROW_BY_ROW_BYTES else [slice(0, b)])
    err, scale = [0.0] * 3, [0.0] * 3
    for r in rows:
        ref_in = [x[r].clone().requires_grad_(True) for x in (q, k, v)]
        o_ref, _ = FA.flash_attention_reference(*ref_in, lens_t[r], **kw)
        ref = torch.autograd.grad(o_ref, ref_in, g[r])
        for i in range(3):
            err[i] = max(err[i], abs_err(got[i][r], ref[i]))
            scale[i] = max(scale[i], ref[i].float().abs().max().item())
        del o_ref, ref, ref_in
    rels = [e / max(s, 1e-30) for e, s in zip(err, scale)]
    tol = TOL[dtype]
    ok = max(rels) <= tol and launched == 1
    log(f"  flash backward {name:<18} {str(dtype)[6:]:<8} rel err dq/dk/dv "
        f"{'/'.join('%.2e' % x for x in rels)} (tol {tol:.0e}; A launched "
        f"{launched}) {'ok' if ok else 'FAIL'}")
    return dict(name=name, dtype=str(dtype)[6:], rel_err=max(rels), ok=ok)


def flash_bwd_timing(dtype):
    """Device ms of the ported backward alone at bench_transformer_lm's
    attention (causal T=8192, B=4, H=8, D=64) beside SDPA's backward on
    the same tensors (its forward run once, its backward timed alone),
    and the backward's bound: 2.5 x the forward's products over valid
    pairs at the bf16 peak, or its bytes (q, k, v, o, g and lse read, dq,
    dk, dv written). The LM path under the bf16 policy feeds attention
    f32 (f32 biases promote the products' bf16 outputs, as in the JAX
    package), so both dtypes are timed."""
    b, t, h = LM_B, LM_T, LM_CFG["n_heads"]
    d = LM_CFG["dim"] // h
    rs = np.random.RandomState(9)
    mk = lambda: torch.from_numpy(rs.standard_normal(
        (b, t, h, d)).astype(np.float32)).to("cuda", dtype)
    q, k, v, g = mk(), mk(), mk(), mk()
    lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
    o, lse = FA.flash_kernel(q, k, v, lens, causal=True)
    ms = time_ms(lambda: FA.flash_backward(q, k, v, lens, o, lse, g,
                                           causal=True), iters=5, warmup=1)
    heads = lambda x: x.transpose(1, 2).contiguous().requires_grad_(True)
    qh, kh, vh = heads(q), heads(k), heads(v)
    out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh,
                                                           is_causal=True)
    gh = g.transpose(1, 2).contiguous()
    sdpa_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                  retain_graph=True))
    pairs = b * h * t * (t + 1) // 2
    bytes_ = 8 * q.numel() * q.element_size() + lse.numel() * 4
    bound_ms, bound_by = bound(bytes_, 2.5 * 4 * d * pairs, torch.bfloat16)
    log(f"  flash backward alone, causal T={t} B={b} H={h} "
        f"{str(dtype)[6:]}: {ms:.4f} ms (device, L2 flushed, mean of 5) vs "
        f"SDPA backward {sdpa_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"({bound_by}: 2.5 x the forward's products at 989 TFLOP/s)")
    return dict(backward_ms=ms, sdpa_backward_ms=sdpa_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def lm_step_flops(cfg, b, t):
    """Operations one training step of TT.loss executes on tokens [b, t]
    (n = b x (t-1) positions), by part: the blocks' products (forward,
    the remat recompute, the backward's two), the LM head's (forward,
    backward's two, the fused CE's recompute), A's over valid (query,
    key) pairs (forward and recompute), and the flash backward's five
    f32 products over every query each key block visits."""
    tq, d, dh, h = t - 1, cfg.dim, cfg.head_dim, cfg.n_heads
    n = b * tq
    per_layer = d * (h + 2 * cfg.kv_heads) * dh + d * d + 2 * d * (
        cfg.mlp_ratio * d)
    qpos, kpos = np.arange(tq)[:, None], np.arange(tq)[None, :]
    band = qpos >= kpos
    if cfg.attn_window is not None:
        band = band & (qpos - kpos < cfg.attn_window)
    bk = FA.DEFAULT_BLOCK_K
    rows = tq if cfg.attn_window is None else bk + min(cfg.attn_window,
                                                       tq) - 1
    parts = dict(
        blocks=2 * n * per_layer * cfg.n_layers * 4,
        lm_head=2 * n * d * cfg.vocab * (4 if cfg.fused_ce_chunk else 3),
        attention_fwd=2 * 4 * dh * int(band.sum()) * b * h * cfg.n_layers,
        attention_bwd=(5 * 2 * dh * rows * bk * -(-tq // bk) * b * h
                       * cfg.n_layers))
    return sum(parts.values()), parts


def lm_step(params, cfg, tokens, opt, opt_state, step):
    """The bench's hand-rolled step: loss and gradients, then adam's
    update in place. Returns the loss (a tensor)."""
    loss = TT.loss(params, cfg, tokens)
    it = iter(torch.autograd.grad(loss, tree_leaves(params)))
    opt.update(tree_map(lambda _: next(it), params), opt_state, params,
               step)
    return loss.detach()


def lm_train(params, cfg, tokens, steps, opt_state=None):
    """`steps` steps on one batch from params (updated in place): (losses
    as tensors, the adam state)."""
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params) if opt_state is None else opt_state
    losses = [lm_step(params, cfg, tokens, opt, opt_state,
                      torch.tensor(i, dtype=torch.int32, device="cuda"))
              for i in range(steps)]
    return losses, opt_state


class attention_spy:
    """Counts the calls of the dense attention and of the flash plain
    version while entered (neither may run on the kernel path). With
    plain=True the flash Function's forward takes the plain version on
    CUDA tensors too (the plain path), so kernel A must not launch."""

    def __init__(self, plain=False):
        self.plain, self.calls = plain, {"dense": 0, "flash_plain": 0}

    def __enter__(self):
        self.saved = (TT._dense_attention, FA.flash_attention_reference,
                      FA.flash_kernel)

        def count(key, fn):
            def counted(*a, **kw):
                self.calls[key] += 1
                return fn(*a, **kw)
            return counted

        TT._dense_attention = count("dense", self.saved[0])
        FA.flash_attention_reference = count("flash_plain", self.saved[1])
        if self.plain:
            FA.flash_kernel = FA.flash_attention_reference
        return self

    def __exit__(self, *exc):
        (TT._dense_attention, FA.flash_attention_reference,
         FA.flash_kernel) = self.saved


def lm_variant(name, params0, tokens, **cfg_kw):
    """One full-width variant under the bf16 policy, from a copy of
    params0: a warm-up step, then LM_STEPS timed steps ending in a sync;
    A's launches counted from 0 before the warm-up."""
    cfg = TT.TransformerConfig(**LM_CFG, **cfg_kw)
    params = trainable(params0)
    torch.cuda.synchronize()
    FA.reset_launch_counts()
    with attention_spy() as spy:
        first, opt_state = lm_train(params, cfg, tokens, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rest, _ = lm_train(params, cfg, tokens, LM_STEPS, opt_state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = FA.launch_counts["fwd"]
    losses = [x.item() for x in first + rest]
    step_s = wall / LM_STEPS
    flops, parts = lm_step_flops(cfg, LM_B, LM_T)
    out = dict(variant=name, ms_per_step=1e3 * step_s,
               tokens_per_s=LM_B * LM_T / step_s, step_flops=flops,
               step_flops_by_part=parts,
               mfu_pct=100 * flops / step_s / PEAK_FLOPS[torch.bfloat16],
               a_launches=launched, a_launches_per_step=launched / (
                   1 + LM_STEPS), losses=losses, attention_calls=spy.calls)
    log(f"  {name:<14} {out['ms_per_step']:.1f} ms/step = "
        f"{out['tokens_per_s']:.0f} tokens/s; {flops / 1e12:.2f} TFLOP a "
        f"step, mfu_pct {out['mfu_pct']:.2f}; A {launched} launches "
        f"({out['a_launches_per_step']:g} per step); dense / flash plain "
        f"calls {spy.calls}; losses {['%.5f' % x for x in losses]}")
    want = 2 * LM_CFG["n_layers"] * (1 + LM_STEPS)
    if launched != want:
        raise Fail(f"lm_train {name}: A launched {launched} times, want "
                   f"{want} (a forward and a remat recompute per layer per "
                   f"step)")
    if any(spy.calls.values()):
        raise Fail(f"lm_train {name}: attention ran off kernel A: "
                   f"{spy.calls}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise Fail(f"lm_train {name}: losses not finite, or not falling on "
                   f"the memorized batch: {losses}")
    return out


def lm_parity(params0, tokens, dtype, **cfg_kw):
    """LM_PARITY_STEPS steps on kernel A and on the plain path from the
    same weights (remat on, the current policy, cfg_kw such as
    attn_window on both): first-step gradients per leaf and every loss,
    A's launches on each path."""
    grad_tol, loss_tol = LM_PARITY_TOL[dtype]
    cfg = TT.TransformerConfig(**LM_CFG, **cfg_kw, attn_impl="flash")
    runs = {}
    for path in ("kernel", "plain"):
        params = trainable(params0)
        FA.reset_launch_counts()
        with attention_spy(plain=path == "plain") as spy:
            loss = TT.loss(params, cfg, tokens)
            grads = torch.autograd.grad(loss, tree_leaves(params))
            losses, _ = lm_train(params, cfg, tokens, LM_PARITY_STEPS)
        runs[path] = dict(grads=grads, losses=[x.item() for x in losses],
                          launched=FA.launch_counts["fwd"], calls=spy.calls)
        del params
    k, p = runs["kernel"], runs["plain"]
    g_err, _ = leaf_rel_errs(params0, k["grads"], p["grads"])
    l_err = max(abs(a - b) / abs(b) for a, b in zip(k["losses"],
                                                    p["losses"]))
    name = str(dtype)[6:] + "".join(f" {k}={v}" for k, v in cfg_kw.items())
    log(f"  parity {name:<8} T={tokens.shape[1]}: first-step gradients max "
        f"rel err {g_err:.2e} (tol {grad_tol:.0e}), losses {l_err:.2e} (tol "
        f"{loss_tol:.0e}); A launches: kernel path {k['launched']}, plain "
        f"path {p['launched']} ({p['calls']['flash_plain']} plain calls); "
        f"losses {['%.6f' % x for x in k['losses']]} vs "
        f"{['%.6f' % x for x in p['losses']]}")
    want = 2 * LM_CFG["n_layers"] * (1 + LM_PARITY_STEPS)
    if k["launched"] != want or any(k["calls"].values()):
        raise Fail(f"lm_train parity {name}: the kernel path launched A "
                   f"{k['launched']} times (want {want}); attention calls "
                   f"off A {k['calls']}")
    if p["launched"] or p["calls"]["dense"] or not p["calls"]["flash_plain"]:
        raise Fail(f"lm_train parity {name}: the plain path launched A "
                   f"{p['launched']} times; attention calls {p['calls']}")
    if g_err > grad_tol or l_err > loss_tol:
        raise Fail(f"lm_train parity {name}: kernel and plain paths "
                   f"differ: gradients {g_err:.2e}, losses {l_err:.2e}")
    return dict(grad_rel_err=g_err, loss_rel_err=l_err, losses=k["losses"],
                plain_losses=p["losses"])


def same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def lm_checkpoint_round_trip(params0, tokens):
    """CheckpointManager(max_to_keep=2) saves 3 kernel-path steps (the
    current policy): steps 2 and 3 remain, the state restored into a
    fresh template equals the live one leaf for leaf, one more step from
    each gives the same loss bit for bit, and the parameters tar
    round-trips the params exactly."""
    cfg = TT.TransformerConfig(**LM_CFG, attn_impl="flash")
    opt = OPT.adam(1e-3)
    state = TrainState.create(trainable(params0), {}, opt)
    template = TrainState.create(
        trainable(TT.init_params(LM_SEED + 1, cfg, device="cuda")), {}, opt)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CK.CheckpointManager(os.path.join(tmp, "ckpt"), max_to_keep=2)
        for _ in range(3):
            lm_step(state.params, cfg, tokens, opt, state.opt_state,
                    state.step)
            state = state._replace(step=state.step + 1)
            mgr.save(state)
        kept = mgr.all_steps()
        restored = mgr.restore(template)
        equal = all(same_tree(getattr(restored, f), getattr(state, f))
                    for f in ("params", "opt_state", "step"))
        restored = restored._replace(params=trainable(restored.params))
        live = lm_step(state.params, cfg, tokens, opt, state.opt_state,
                       state.step)
        again = lm_step(restored.params, cfg, tokens, opt,
                        restored.opt_state, restored.step)
        tar = os.path.join(tmp, "params.tar")
        CK.save_parameters_tar(state.params, tar)
        tar_exact = same_tree(
            CK.load_parameters_tar(template.params, tar), state.params)
        mgr.close()
    bitwise = bool(torch.equal(live, again))
    log(f"  checkpoints: steps kept {kept} (max_to_keep 2); restored state "
        f"equal {equal}; one more step: loss {live.item():.7f} live, "
        f"{again.item():.7f} restored, bitwise {bitwise}; parameters tar "
        f"round trip exact {tar_exact}")
    if kept != [2, 3] or not (equal and bitwise and tar_exact):
        raise Fail(f"lm_train checkpoints: steps {kept}, restored equal "
                   f"{equal}, losses bitwise {bitwise}, tar exact "
                   f"{tar_exact}")
    return dict(steps_kept=kept, restored_equal=equal, loss_bitwise=bitwise,
                tar_exact=tar_exact)


def lm_train_phase():
    """The transformer LM's training path at bench_transformer_lm's width:
    the flash backward's cases and its time beside SDPA's, three
    full-width variants (bf16 policy, remat), parity with the plain path
    at T=LM_PARITY_T (f32, f32 in the window of LM_WINDOW keys, then
    bf16) and a checkpoint round trip."""
    log(f"phase lm_train: transformer LM {LM_CFG}, B={LM_B} T={LM_T}, adam "
        f"1e-3, the same batch every step")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [flash_bwd_case("causal_t2048", b=1, t=2048, h=8, dtype=dt)
             for dt in (f32, bf16)]
    cases += [
        flash_bwd_case("key_lens", b=4, t=512, h=8, lens=[512, 300, 37, 1],
                       seed=1),
        flash_bwd_case("window256_t2048", b=2, t=2048, h=8, window=256,
                       lens=[2048, 1500], seed=2),
        flash_bwd_case("head_dim128", b=1, t=256, h=4, d=128, seed=3),
        flash_bwd_case("head_dim128", b=1, t=256, h=4, d=128, dtype=bf16,
                       seed=3),
        flash_bwd_case("causal_t8192_b4", b=LM_B, t=LM_T, h=8, dtype=bf16,
                       seed=4),
    ]
    bad = [f"{c['name']}[{c['dtype']}]" for c in cases if not c["ok"]]
    if bad:
        raise Fail(f"lm_train: flash gradients disagree with the plain "
                   f"version: {bad}")
    timing = {str(dt)[6:]: flash_bwd_timing(dt) for dt in (bf16, f32)}
    torch.cuda.empty_cache()

    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, LM_CFG["vocab"], (LM_B, LM_T))
                              .astype(np.int32)).cuda()
    params0 = TT.init_params(LM_SEED, TT.TransformerConfig(**LM_CFG),
                             device="cuda")
    prev = TD.default_policy()
    TD.set_default_policy(TD.bf16_compute_policy())
    try:
        variants = [lm_variant("full_causal", params0, tokens),
                    lm_variant("window_1024", params0, tokens,
                               attn_window=LM_WINDOW),
                    lm_variant("fused_ce_2048", params0, tokens,
                               fused_ce_chunk=LM_CE_CHUNK)]
    finally:
        TD.set_default_policy(prev)
    torch.cuda.empty_cache()
    first = [v["losses"][0] for v in variants]
    ce_rel = abs(first[2] - first[0]) / abs(first[0])
    log(f"  fused CE's first loss {first[2]:.6f} vs unfused {first[0]:.6f}: "
        f"{ce_rel:.2e} relative (tol {LOSS_RTOL:.0e})")
    if ce_rel > LOSS_RTOL:
        raise Fail(f"lm_train: the fused CE's first loss differs: "
                   f"{ce_rel:.2e}")

    short = tokens[:, :LM_PARITY_T].contiguous()
    parity = {"float32": lm_parity(params0, short, f32),
              "float32_window_1024": lm_parity(params0, short, f32,
                                               attn_window=LM_WINDOW)}
    ckpt = lm_checkpoint_round_trip(params0, short)
    TD.set_default_policy(TD.bf16_compute_policy())
    try:
        parity["bfloat16"] = lm_parity(params0, short, bf16)
    finally:
        TD.set_default_policy(prev)
    del params0, tokens, short
    torch.cuda.empty_cache()
    return dict(flash_backward_cases=cases, flash_backward_timing=timing,
                variants=variants, fused_ce_first_loss_rel=ce_rel,
                parity=parity, checkpoint=ckpt,
                a_launches=sum(v["a_launches"] for v in variants),
                a_launches_per_step=variants[0]["a_launches_per_step"])


# -- the image models: training at bench_image's width -------------------------

# bench_image (benchmarks/suite.py:112-141: momentum(0.1, mu=0.9), softmax
# CE, make_train_step(donate=True), bf16 policy, inputs RandomState(0).rand,
# labels RandomState(1)) at the configs of :765-775; resnet50 also at 64
IMAGE_HW, IMAGE_STEPS = 224, 5
IMAGE_CONFIGS = (("resnet50", 64), ("resnet50", 256), ("resnet50_s2d", 256),
                 ("resnet50_remat", 256), ("resnet50_remat_full", 256),
                 ("alexnet", 128), ("googlenet", 128), ("vgg19", 64),
                 ("smallnet", 512))
# analytic forward GFLOPs per image at 224x224 (2 x MACs), a copy of
# paddle_tpu/core/hw.py FWD_GFLOPS; mfu_pct = 3 x this x batch over the
# step time over the card's bf16 peak, as benchmarks/suite.py:799-800
FWD_GFLOPS = {"resnet50": 8.2, "resnet50_s2d": 8.2, "resnet50_remat": 8.2,
              "resnet50_remat_full": 8.2, "vgg19": 39.0, "alexnet": 1.4,
              "googlenet": 3.0}
# CUDA against the port's CPU path: (model, batch, side) at f32; resnet50
# also under the bf16 policy and for 3 momentum steps
IMAGE_PARITY = (("resnet50", 4, IMAGE_HW), ("googlenet", 2, IMAGE_HW),
                ("alexnet", 2, IMAGE_HW), ("vgg19", 2, IMAGE_HW),
                ("smallnet", 2, 32))
# (logits and gradients, losses) per compute dtype
IMAGE_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 1e-2)}
TRAINER_LOOP_B = 64
# the timed runs' learning rate (momentum 0.9): the bench's 0.1 diverges on
# one repeated batch, in the JAX package as in the port
# (tests/test_torch_image_models.py,
# test_bench_recipe_diverges_alike_in_jax_and_the_port)
IMAGE_LR = 0.01
F64 = TD.Policy(torch.float64, torch.float64, torch.float64)


def image_model(name, dropout=True):
    """suite.py:84 _image_model; dropout=False zeroes the dropout rates
    (parity runs: torch's draws never match the plain path's)."""
    drop = {} if dropout else {"dropout": 0.0}
    if name == "alexnet":
        return IM_ALEXNET.alexnet(num_classes=1000, **drop)
    if name == "googlenet":
        return IM_GOOGLENET.googlenet(num_classes=1000, **drop)
    if name == "vgg19":
        return IM_VGG.vgg(19, num_classes=1000, **drop)
    if name == "smallnet":
        return IM_SMALLNET.smallnet(num_classes=10)
    kw = {"resnet50_s2d": dict(s2d_stem=True),
          "resnet50_remat": dict(remat="conv_out"),
          "resnet50_remat_full": dict(remat="full")}.get(name, {})
    return IM_RESNET.resnet(50, num_classes=1000, **kw)


def image_batch(batch, hw, classes, device, seed=0):
    x = np.random.RandomState(seed).rand(batch, hw, hw, 3).astype(np.float32)
    y = np.random.RandomState(seed + 1).randint(0, classes, batch)
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


def with_policy(policy, fn, *a, **kw):
    prev = TD.default_policy()
    TD.set_default_policy(policy)
    try:
        return fn(*a, **kw)
    finally:
        TD.set_default_policy(prev)


def tree_to(tree, device, dtype=None):
    return tree_map(lambda t: t.detach().to(device=device, dtype=dtype
                                            or t.dtype).clone(), tree)


def rel64(got, ref):
    """max |got - ref| over max |ref|, in float64 (the image phase's
    results are f64 host tensors)."""
    return ((got.double().cpu() - ref.double().cpu()).abs().max().item()
            / max(ref.double().abs().max().item(), 1e-30))


def leaf_errs(got, want):
    """{leaf name: error}: each leaf's max abs error over its max |want|,
    floored at LEAF_FLOOR x the largest |want| of any leaf."""
    names = []
    tree_map_with_name(lambda n, _: names.append(n), want)
    ga, gb = tree_leaves(got), tree_leaves(want)
    top = max((b.abs().max().item() for b in gb), default=0.0)
    return {n: (a.double().cpu() - b.double().cpu()).abs().max().item()
            / max(b.abs().max().item(), LEAF_FLOOR * top, 1e-30)
            for n, a, b in zip(names, ga, gb)}


def tree_err(got, want):
    """(worst leaf, its error) of `leaf_errs`."""
    errs = leaf_errs(got, want)
    if not errs:
        return None, 0.0
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def replay_gate(replay, tol, label):
    """The gate of an OpReplay: every op's error within `tol` and its
    integer or bool outputs equal to the CPU's. Logs the largest errors;
    returns the failing op names and a summary."""
    fails = [n for n, r in replay.ops.items()
             if r["err"] > tol or r["int_diffs"]]
    top = sorted(replay.ops.items(), key=lambda kv: -kv[1]["err"])
    calls = sum(r["calls"] for r in replay.ops.values())
    log(f"    {label}: {calls} op calls of {len(replay.ops)} kinds replayed "
        f"on the CPU (tol {tol:.0e}, integer outputs equal); largest "
        + ", ".join(f"{n} x{r['calls']} {r['err']:.1e}" for n, r in top[:5])
        + f"; failing {fails}")
    return fails, dict(calls=calls, kinds=len(replay.ops), ops=replay.ops)


def ulp_nudge(x):
    """x with half its elements, picked from a seed, moved up by one ulp:
    the same batch as far as its dtype can tell, rounded another way."""
    pick = torch.from_numpy(np.random.RandomState(3).rand(*x.shape) < 0.5)
    return torch.where(pick.to(x.device), torch.nextafter(
        x, torch.full_like(x, float("inf"))), x)


class OpReplay(TorchDispatchMode):
    """Holds every op a step runs on the card against the same op run on
    the CPU on copies of the card's inputs: no error is amplified on the
    way, so each op is held on its own conditioning. Per op name it
    keeps the calls, the largest error of a floating output (max abs
    error over max |CPU|) and the integer or bool outputs (max-pool
    indices) that differ. Views, allocations and scalar reads are not
    replayed."""

    SKIP = ("empty", "new_empty", "empty_like", "empty_strided",
            "_local_scalar_dense", "copy_", "detach", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.ops = {}

    @staticmethod
    def _host(a):
        if isinstance(a, torch.Tensor):
            # NCHW-contiguous on the CPU (see ops/conv.py)
            return a.detach().to("cpu").contiguous()
        if isinstance(a, torch.device):
            return torch.device("cpu")
        return a

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        if view or name in self.SKIP or not any(
                isinstance(a, torch.Tensor)
                for a in pytree.tree_leaves((args, kwargs))):
            return func(*args, **kwargs)
        # the inputs are copied before the op runs: it may write one
        host_args, host_kwargs = pytree.tree_map(self._host, (args, kwargs))
        out = func(*args, **kwargs)
        ref = func(*host_args, **host_kwargs)
        rec = self.ops.setdefault(name, dict(calls=0, err=0.0, int_diffs=0))
        rec["calls"] += 1
        for o, r in zip(pytree.tree_leaves(out), pytree.tree_leaves(ref)):
            if not isinstance(o, torch.Tensor) or not o.numel():
                continue
            o = o.detach().cpu()
            if o.is_floating_point():
                r = r.double()
                rec["err"] = max(rec["err"], (o.double() - r).abs().max()
                                 .item() / max(r.abs().max().item(), 1e-30))
            else:
                rec["int_diffs"] += int((o != r).sum().item())
        return out


def image_run(model, params, mstate, x, y, policy, mode=None):
    """Eval logits and one training forward and backward under `policy`
    (the weights and inputs in its param dtype), inside `mode` (an
    OpReplay) if given: dict of eval logits, loss, train logits, grads
    and the new model state, all on the CPU in float64."""
    dt = policy.param_dtype
    p, s = tree_to(params, x.device, dt), tree_to(mstate, x.device, dt)
    xd = x.to(dt)

    def run():
        with torch.no_grad():
            logits, _ = model.apply(p, s, xd, training=False)
        loss, new_state, grads, met = loss_and_grads(
            model, ce_loss, p, s, None, (xd,), (y,),
            metrics_fn=lambda out, _: {"logits": out})
        return logits, loss, met["logits"], grads, new_state

    if mode is None:
        logits, loss, tlogits, grads, new_state = with_policy(policy, run)
    else:
        with mode:
            logits, loss, tlogits, grads, new_state = with_policy(policy, run)
    host = lambda t: tree_map(lambda a: a.detach().double().cpu(), t)
    return dict(logits=host(logits), loss=loss.item(),
                train_logits=host(tlogits), grads=host(grads),
                state=host(NM.merge_state(s, new_state)))


def image_parity_case(name, batch, hw):
    """The model on the card and on the port's CPU path from the same
    weights (drawn in f32) and batch. Held: f32 eval logits and loss
    directly (well conditioned); f64 on both devices (the semantics:
    every logit, the loss, each gradient and BN state leaf); the f32
    step op by op (OpReplay: each op the card runs, against the same op
    on the CPU on its own inputs); and the f32 step's gradients and BN
    state leaf by leaf at 1e-4 where the model is well conditioned in f32
    there: where moving half the inputs by one ulp moves no CPU leaf by
    more than tol/10. Elsewhere -- a BN net's batch statistics at these
    batches, or GoogLeNet's max pools and ReLUs, where an ulp decides a
    near tie -- the f32 leaves' errors against the CPU f64 run are
    printed for both devices beside the CPU's own one-ulp spread."""
    classes = 10 if name == "smallnet" else 1000
    model = image_model(name, dropout=False)
    params, mstate = model.init(0, NM.ShapeSpec((batch, hw, hw, 3)),
                                device="cpu")
    x, y = image_batch(batch, hw, classes, "cpu", seed=2)
    f32 = TD.Policy()
    t0 = time.perf_counter()
    cpu = {"f32": image_run(model, params, mstate, x, y, f32),
           "nudged": image_run(model, params, mstate, ulp_nudge(x), y, f32),
           "f64": image_run(model, params, mstate, x, y, F64)}
    cpu_s = time.perf_counter() - t0
    xc, yc = x.cuda(), y.cuda()
    replay = OpReplay()
    t0 = time.perf_counter()
    gpu = {"f32": image_run(model, params, mstate, xc, yc, f32, replay)}
    replay_s = time.perf_counter() - t0
    gpu["f64"] = image_run(model, params, mstate, xc, yc, F64)
    tol, loss_tol = IMAGE_TOL[torch.float32]
    truth = cpu["f64"]
    out = dict(model=name, batch=batch, hw=hw, cpu_seconds=cpu_s,
               replay_seconds=replay_s)
    g, c = gpu["f32"], cpu["f32"]
    errs = {
        "f32_eval_logits": rel64(g["logits"], c["logits"]),
        "f32_loss": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
        "f64_eval_logits": rel64(gpu["f64"]["logits"], truth["logits"]),
        "f64_train_logits": rel64(gpu["f64"]["train_logits"],
                                    truth["train_logits"]),
        "f64_loss": abs(gpu["f64"]["loss"] - truth["loss"]) / abs(
            truth["loss"]),
        "f64_grads": tree_err(gpu["f64"]["grads"], truth["grads"]),
        "f64_state": tree_err(gpu["f64"]["state"], truth["state"]),
    }
    bad = [k for k in ("f32_eval_logits", "f64_eval_logits",
                       "f64_train_logits", "f64_loss") if errs[k] > tol]
    bad += ["f32_loss"] if errs["f32_loss"] > loss_tol else []
    bad += [k for k in ("f64_grads", "f64_state") if errs[k][1] > tol]
    log(f"  parity {name} B={batch} {hw}x{hw} (CPU side {cpu_s:.1f} s, the "
        f"card's f32 step with its op replay {replay_s:.1f} s): f32 eval "
        f"logits {errs['f32_eval_logits']:.2e}, loss {errs['f32_loss']:.2e}; "
        f"f64 eval {errs['f64_eval_logits']:.2e}, train logits "
        f"{errs['f64_train_logits']:.2e}, loss {errs['f64_loss']:.2e}, "
        f"grads {errs['f64_grads'][1]:.2e} ({errs['f64_grads'][0]}), state "
        f"{errs['f64_state'][1]:.2e} (tol {tol:.0e} / {loss_tol:.0e})")
    fails, out["op_replay"] = replay_gate(replay, tol, "f32 step op by op")
    bad += [f"f32_op:{n}" for n in fails]
    # the f32 step leaf by leaf: the CPU's own one-ulp spread decides
    # whether a direct gate can hold
    trees = ("train_logits", "grads", "state")
    meas = lambda w, a, b: (("logits", rel64(a[w], b[w])) if w ==
                            "train_logits" else tree_err(a[w], b[w]))
    spread = {w: meas(w, cpu["nudged"], c) for w in trees}
    direct = {w: meas(w, g, c) for w in trees}
    vs_f64 = {w: {"cuda": meas(w, g, truth), "cpu": meas(w, c, truth)}
              for w in trees}
    held = all(v[1] <= tol / 10 for v in spread.values())
    if held:
        bad += [f"f32_{w}_direct" for w, v in direct.items() if v[1] > tol]
    out.update(errs=errs, f32_leaves=dict(
        one_ulp_spread=spread, direct=direct, vs_f64=vs_f64,
        direct_gate=held))
    log(f"    f32 step leaf by leaf: the CPU's own one-ulp spread "
        + ", ".join(f"{w} {v[1]:.2e} ({v[0]})" for w, v in spread.items())
        + (f" -> held directly at {tol:.0e}: " if held else
           " -> no direct gate can hold; printed: ")
        + ", ".join(f"{w} {v[1]:.2e} ({v[0]})" for w, v in direct.items()))
    log("      against the CPU f64 run, card / CPU: " + ", ".join(
        f"{w} {v['cuda'][1]:.2e} / {v['cpu'][1]:.2e}"
        for w, v in vs_f64.items()))
    if name == "resnet50":
        out.update(image_resnet50_extra(model, params, mstate, x, y, truth))
        bad += out.pop("bad")
    out["failing"] = bad
    return out


def image_resnet50_extra(model, params, mstate, x, y, truth):
    """resnet50's bf16-policy step (CUDA vs CPU: eval logits and loss
    directly, the step op by op; the gradients against the CPU f64 run
    printed for both devices) and 3 momentum steps on both devices: f64
    gated (losses 1e-3, BN state 1e-4), f32 and bf16 printed."""
    bf16 = TD.bf16_compute_policy()
    tol, loss_tol = IMAGE_TOL[torch.bfloat16]
    xc, yc = x.cuda(), y.cuda()
    cpu_b = image_run(model, params, mstate, x, y, bf16)
    replay = OpReplay()
    gpu_b = image_run(model, params, mstate, xc, yc, bf16, replay)
    eval_err = rel64(gpu_b["logits"], cpu_b["logits"])
    loss_err = abs(gpu_b["loss"] - cpu_b["loss"]) / abs(cpu_b["loss"])
    grad_err = {d: tree_err(r["grads"], truth["grads"])
                for d, r in (("cuda", gpu_b), ("cpu", cpu_b))}
    bad = ["bf16_eval_logits"] if eval_err > tol else []
    bad += ["bf16_loss"] if loss_err > loss_tol else []
    log(f"    bf16 policy: eval logits CUDA vs CPU {eval_err:.2e}, loss "
        f"{loss_err:.2e} (tol {tol:.0e} / {loss_tol:.0e}); gradients against "
        f"the CPU f64 run (printed): card {grad_err['cuda'][1]:.2e} "
        f"({grad_err['cuda'][0]}), CPU {grad_err['cpu'][1]:.2e} "
        f"({grad_err['cpu'][0]})")
    fails, op_replay = replay_gate(replay, tol, "bf16 step op by op")
    bad += [f"bf16_op:{n}" for n in fails]
    steps = {}
    for label, policy in (("f64", F64), ("f32", TD.Policy()),
                          ("bf16", bf16)):
        runs = {}
        for dev, xx, yy in (("cuda", xc, yc), ("cpu", x, y)):
            state, losses, _ = image_steps(model, params, mstate, xx, yy,
                                           policy=policy)
            runs[dev] = ([v.item() for v in losses], tree_map(
                lambda a: a.double().cpu(), state.model_state))
        g, c = runs["cuda"], runs["cpu"]
        l_err = max(abs(a - b) / abs(b) for a, b in zip(g[0], c[0]))
        s_err = tree_err(g[1], c[1])
        steps[label] = dict(cuda_losses=g[0], cpu_losses=c[0],
                            loss_rel_err=l_err, state_err=s_err)
        gated = label == "f64"
        log(f"    3 momentum steps, {label}{'' if gated else ' (printed)'}: "
            f"losses {['%.6f' % v for v in g[0]]} vs "
            f"{['%.6f' % v for v in c[0]]}: {l_err:.2e}; BN state "
            f"{s_err[1]:.2e} ({s_err[0]})")
        if gated and (l_err > IMAGE_TOL[torch.float32][1]
                      or s_err[1] > IMAGE_TOL[torch.float32][0]):
            bad.append("f64_three_steps")
    return dict(bad=bad, bf16=dict(eval_logits=eval_err, loss=loss_err,
                                   grads_vs_f64=grad_err, op_replay=op_replay),
                three_steps=steps)


def bn_means(state):
    """The first BN's running mean (None for a model without BN)."""
    means = []
    tree_map_with_name(lambda n, t: means.append(t) if n.endswith("mean")
                       else None, state)
    return means[0].clone() if means else None


def image_steps(model, params, mstate, x, y, *, policy=None, gen=None,
                steps=2):
    """1 + `steps` steps of momentum(IMAGE_LR, mu=0.9) through
    make_train_step(donate=True) under `policy` (None: bf16), from copies of params and
    mstate on x's device in the policy's param dtype (dropout masks from
    `gen`, seeded 0 before every step, as the bench's fixed key): (state,
    loss tensors, seconds of the last `steps` steps, ending in a sync)."""
    policy = policy or TD.bf16_compute_policy()
    dt = policy.param_dtype
    opt = OPT.momentum(IMAGE_LR, mu=0.9)
    state = TrainState.create(tree_to(params, x.device, dt),
                              tree_to(mstate, x.device, dt), opt)
    step = make_train_step(model, ce_loss, opt, donate=True)
    xd, losses = x.to(dt), []
    for i in range(1 + steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if gen is not None:
            gen.manual_seed(0)
        state, loss, _ = with_policy(policy, step, state, gen, (xd,), (y,))
        losses.append(loss)
    torch.cuda.synchronize()
    return state, losses, time.perf_counter() - t0


def image_train(name, batch):
    """bench_image's step at its width: 1 warm-up step and IMAGE_STEPS
    timed ones on one batch with momentum(IMAGE_LR, mu=0.9) (the bench's
    lr 0.1 diverges on one repeated batch; a step's time does not depend
    on the lr). Every loss finite, the last below the first (the batch
    is memorized) and the BN running stats moved."""
    hw = 32 if name == "smallnet" else IMAGE_HW
    classes = 10 if name == "smallnet" else 1000
    model = image_model(name)
    params, mstate = model.init(0, NM.ShapeSpec((batch, hw, hw, 3)),
                                device="cuda")
    x, y = image_batch(batch, hw, classes, "cuda")
    gen = torch.Generator(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses, secs = image_steps(model, params, mstate, x, y, gen=gen,
                                      steps=IMAGE_STEPS)
    step_s = secs / IMAGE_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [v.item() for v in losses]
    mean0, mean1 = bn_means(mstate), bn_means(state.model_state)
    moved = None if mean0 is None else bool(
        (mean1 - mean0).abs().max().item() > 0)
    rec = dict(bench=name, batch=batch, hw=hw, ms_per_batch=1e3 * step_s,
               imgs_per_sec=batch / step_s, peak_memory_bytes=peak,
               lr=IMAGE_LR, losses=losses, bn_stats_moved=moved)
    if name in FWD_GFLOPS:
        rec["mfu_pct"] = 100 * 3 * FWD_GFLOPS[name] * 1e9 * batch / step_s \
            / PEAK_FLOPS[torch.bfloat16]
    log(f"  {name:<20} B={batch:<4} {rec['ms_per_batch']:9.2f} ms/batch "
        f"{rec['imgs_per_sec']:9.1f} imgs/s mfu_pct "
        f"{rec.get('mfu_pct', float('nan')):6.2f} peak "
        f"{peak / 2**30:6.2f} GiB; losses at lr {IMAGE_LR} "
        f"{['%.4f' % v for v in losses]}; BN stats moved {moved}")
    del state, params, mstate, x, y
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise Fail(f"image {name} B={batch}: the losses are not finite or "
                   f"the last is not below the first: {losses}")
    if moved is False:
        raise Fail(f"image {name} B={batch}: BN running stats did not move")
    return rec


def image_trainer_loop():
    """bench_trainer_loop (suite.py:404): resnet50 through Trainer.train
    with a lazy EndIteration handler: 2 warm-up batches, then
    IMAGE_STEPS timed, ending in a sync; the raw step's ms beside it."""
    model = image_model("resnet50")
    opt = OPT.momentum(IMAGE_LR, mu=0.9)
    trainer = Trainer(model, ce_loss, opt)
    state = trainer.init_state(NM.ShapeSpec((TRAINER_LOOP_B, IMAGE_HW,
                                             IMAGE_HW, 3)))
    x, y = image_batch(TRAINER_LOOP_B, IMAGE_HW, 1000, "cuda")
    last = []

    def handler(ev):
        if isinstance(ev, EV.EndIteration) and ev.batch_id == IMAGE_STEPS - 1:
            last.append(ev.cost)

    batches = lambda n: (lambda: ((x, y) for _ in range(n)))
    state = with_policy(TD.bf16_compute_policy(), trainer.train, state,
                        batches(2), event_handler=handler)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = with_policy(TD.bf16_compute_policy(), trainer.train, state,
                        batches(IMAGE_STEPS), event_handler=handler)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / IMAGE_STEPS
    cost = float(last[-1])
    del state
    torch.cuda.empty_cache()
    if not np.isfinite(cost):
        raise Fail(f"image trainer loop: cost {cost}")
    return dict(batch=TRAINER_LOOP_B, ms_per_batch=ms, last_cost=cost)


def image_trainer_dropout(steps=3):
    """AlexNet (its two Dropout(0.5) layers on) at bench_image's batch
    through Trainer.train: the trainer's step generator is on the card,
    so the masks are drawn there (Dropout raises for a generator on
    another device); every cost finite."""
    batch = dict(IMAGE_CONFIGS)["alexnet"]
    trainer = Trainer(image_model("alexnet"), ce_loss,
                      OPT.momentum(IMAGE_LR, mu=0.9))
    state = trainer.init_state(NM.ShapeSpec((batch, IMAGE_HW, IMAGE_HW, 3)))
    x, y = image_batch(batch, IMAGE_HW, 1000, "cuda")
    costs = []
    state = with_policy(
        TD.bf16_compute_policy(), trainer.train, state,
        lambda: ((x, y) for _ in range(steps)),
        event_handler=lambda ev: costs.append(float(ev.cost))
        if isinstance(ev, EV.EndIteration) else None)
    gen_device = str(trainer._rng.device)
    del state
    torch.cuda.empty_cache()
    log(f"  Trainer.train alexnet (dropout 0.5) B={batch}: step generator on "
        f"{gen_device}, costs {['%.4f' % c for c in costs]}")
    if not gen_device.startswith("cuda") or len(costs) != steps or not all(
            np.isfinite(costs)):
        raise Fail(f"image trainer dropout: generator on {gen_device}, "
                   f"costs {costs}")
    return dict(model="alexnet", batch=batch, generator=gen_device,
                costs=costs)


def image_graft_entry():
    """paddle_tpu_torch.graft_entry.entry(): one ResNet-50 bf16 eval
    forward at batch 16, 224x224; finite [16, 1000] logits."""
    prev = TD.default_policy()
    try:
        fn, args = GRAFT.entry()
        out = fn(*args)
        torch.cuda.synchronize()
    finally:
        TD.set_default_policy(prev)
    ok = tuple(out.shape) == (16, 1000) and bool(torch.isfinite(out).all())
    log(f"  graft_entry.entry(): logits {tuple(out.shape)} {out.dtype}, "
        f"finite {ok}")
    if not ok:
        raise Fail(f"graft_entry: logits {tuple(out.shape)}, finite {ok}")
    return dict(shape=list(out.shape), finite=ok)


def image_phase():
    """The image models: CUDA-vs-CPU parity (IMAGE_PARITY), bench_image's
    configs (IMAGE_CONFIGS) under the bf16 policy, bench_trainer_loop and
    graft_entry.entry()."""
    log("phase image: parity with the port's CPU path, then bench_image's "
        f"configs (bf16 policy, momentum {IMAGE_LR}/0.9, softmax CE, "
        "make_train_step(donate=True))")
    parity = [image_parity_case(*c) for c in IMAGE_PARITY]
    torch.cuda.empty_cache()
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    log("  torch.backends.cudnn.benchmark = True for the training runs")
    try:
        train = [image_train(*c) for c in IMAGE_CONFIGS]
        loop = image_trainer_loop()
        raw = next(r for r in train if r["bench"] == "resnet50"
                   and r["batch"] == TRAINER_LOOP_B)
        log(f"  bench_trainer_loop resnet50 B={TRAINER_LOOP_B}: "
            f"{loop['ms_per_batch']:.2f} ms/batch through Trainer.train vs "
            f"{raw['ms_per_batch']:.2f} raw step")
        dropout = image_trainer_dropout()
        entry = image_graft_entry()
    finally:
        torch.backends.cudnn.benchmark = prev
    torch.cuda.empty_cache()
    # the parity gates are read last, so that one run reads every model
    bad = {p["model"]: p["failing"] for p in parity if p["failing"]}
    if bad:
        raise Fail(f"image parity: {bad}")
    return dict(parity=parity, train=train, trainer_loop=loop,
                trainer_dropout=dropout, graft_entry=entry)


# -- the serving path ---------------------------------------------------------


def make_prompts():
    rs = np.random.RandomState(1)
    prefix = rs.randint(0, SERVE_CFG["vocab"], SHARED)
    prompts = []
    for i in range(N_REQ):
        if i % 2 == 0:
            tail = rs.randint(0, SERVE_CFG["vocab"], PROMPT - SHARED)
            prompts.append(np.concatenate([prefix, tail]).astype(np.int32))
        else:
            prompts.append(rs.randint(0, SERVE_CFG["vocab"],
                                      PROMPT).astype(np.int32))
    return prompts


def make_spec_prompts(n):
    """Half the prompts repeat a 16-token motif (drafts the n-gram
    proposer gets right), half are random."""
    rs = np.random.RandomState(2)
    prompts = []
    for i in range(n):
        if i % 2 == 0:
            motif = rs.randint(0, SERVE_CFG["vocab"], 16)
            prompts.append(np.tile(motif, PROMPT // 16).astype(np.int32))
        else:
            prompts.append(rs.randint(0, SERVE_CFG["vocab"],
                                      PROMPT).astype(np.int32))
    return prompts


def reset_counts():
    FA.reset_launch_counts()
    RPA.reset_launch_counts()


def counts():
    return {"flash_fwd": FA.launch_counts["fwd"],
            "ragged_tq1": RPA.launch_counts["tq1"],
            "ragged_tqn": RPA.launch_counts["tqn"],
            "int8_tq1": RPA.launch_counts["int8_tq1"],
            "int8_tqn": RPA.launch_counts["int8_tqn"],
            "float_device": RPA.device_launches["float"],
            "int8_device": RPA.device_launches["int8"]}


def timed_serve(eng, prompts, **kw):
    """Serve with every launch count set to 0 just before; returns
    (tokens, wall seconds, launch counts of this run)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = eng.serve(prompts, max_new=MAX_NEW, **kw)
    torch.cuda.synchronize()
    return toks, time.perf_counter() - t0, counts()


def plain_gap(params, plain_cfg, prompt, step):
    """The plain engine's top-2 logit gap at generated token `step` of
    `prompt`: one slot, prefill then `step` decode steps (each mapping
    the next page, as serve() does), reading the logits its token
    selection sees."""
    eng = DecodeEngine(params, plain_cfg, ragged_impl="torch", slots=1,
                       max_len=MAX_LEN, page_size=PAGE)
    seen, select = [], eng._select

    def spy(logits, *a):
        seen.append(logits[0].float())
        return select(logits, *a)

    eng._select = spy
    state = eng.prefill(eng.init_state(), 0, prompt)
    for _ in range(step):
        state = eng.decode_step(state)[0]
        state = eng.ensure_decode_page(state, 0)
    top2 = torch.topk(seen[step], 2).values
    return (top2[0] - top2[1]).item()


def check_greedy(label, toks, ref, prompts, params, plain_cfg):
    """Greedy tokens equal to the reference's, or differing only where
    the plain path's top-2 logit gap is <= GAP_LIMIT (a near tie)."""
    same, worst = 0, None
    for i, (a, b) in enumerate(zip(toks, ref)):
        if a == b:
            same += 1
            continue
        d = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None:
            raise Fail(f"{label}: request {i} emitted {len(a)} tokens, the "
                       f"reference {len(b)}")
        gap = plain_gap(params, plain_cfg, prompts[i], d)
        worst = gap if worst is None else max(worst, gap)
        log(f"  {label}: request {i}: first differing step {d}: {a[d]} vs "
            f"{b[d]}, plain top-2 logit gap {gap:.3e}")
    log(f"  {label}: greedy tokens equal on {same}/{len(toks)} requests")
    if worst is not None and worst > GAP_LIMIT:
        raise Fail(f"{label}: greedy tokens differ at a top-2 gap "
                   f"{worst:.3e} > {GAP_LIMIT}")
    return same


def kernel_and_plain(label, params, cfg, prompts, need):
    """Serve `prompts` on the kernel path and on the plain path (dense
    attention, the walk's plain version); every kernel in `need` must
    have launched in the kernel path's run, none in the plain one's, and
    the greedy tokens must agree."""
    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    eng = DecodeEngine(params, cfg, **geom)
    toks, wall, launched = timed_serve(eng, prompts)
    st = eng.last_stats
    n_tok = sum(len(t) for t in toks)
    log(f"  {label} kernel path: {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} generated tokens/s; steps {st.steps}, prefix "
        f"hits {st.prefix_hits}, launches {launched}")
    missing = [k for k in need if launched[k] == 0]
    if missing:
        raise Fail(f"{label}: kernels never launched: {missing}")
    if any(len(t) != MAX_NEW for t in toks):
        raise Fail(f"{label}: a request did not emit max_new tokens")
    if any(not (0 <= x < cfg.vocab) for t in toks for x in t):
        raise Fail(f"{label}: token out of vocabulary range")
    plain = DecodeEngine(params, plain_cfg, ragged_impl="torch", **geom)
    ptoks, pwall, plaunched = timed_serve(plain, prompts)
    if any(plaunched.values()):
        raise Fail(f"{label}: the plain path launched kernels: {plaunched}")
    log(f"  {label} plain path:  {n_tok} tokens in {pwall:.3f} s = "
        f"{n_tok / pwall:.1f} generated tokens/s")
    same = check_greedy(label, toks, ptoks, prompts, params, plain_cfg)
    return launched, ptoks, dict(
        requests=len(prompts), tokens=n_tok, wall_s=wall,
        tok_s=n_tok / wall, plain_wall_s=pwall, plain_tok_s=n_tok / pwall,
        same=same, steps=st.steps, prefix_hits=st.prefix_hits)


def speculative_vs_plain_decode(label, params, cfg, prompts, tqn_key):
    """serve(speculative=True) against the same engine's one-token
    decode on the same prompts: greedy tokens agree, and every verify
    round read the cache through the walk with TQ = K+1."""
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    eng = DecodeEngine(params, cfg, **geom)
    base, bwall, _ = timed_serve(eng, prompts)
    toks, wall, launched = timed_serve(eng, prompts, speculative=True)
    st = eng.last_stats
    n_tok = sum(len(t) for t in toks)
    need = st.spec_rounds * cfg.n_layers
    log(f"  {label}: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
        f"generated tokens/s (one-token decode {n_tok / bwall:.1f}); "
        f"spec_rounds {st.spec_rounds}, draft_proposed "
        f"{st.draft_proposed}, draft_accepted {st.draft_accepted} "
        f"({st.draft_accepted / max(st.draft_proposed, 1):.3f}), "
        f"launches {launched}")
    if launched[tqn_key] < need:
        raise Fail(f"{label}: {launched[tqn_key]} {tqn_key} launches < "
                   f"{need} verify reads ({st.spec_rounds} rounds x "
                   f"{cfg.n_layers} layers)")
    if st.draft_accepted == 0:
        raise Fail(f"{label}: no draft was accepted")
    same = check_greedy(label, toks, base, prompts, params,
                        dataclasses.replace(cfg, attn_impl="dense"))
    return launched, dict(
        requests=len(prompts), tokens=n_tok, wall_s=wall,
        tok_s=n_tok / wall, decode_tok_s=n_tok / bwall,
        spec_rounds=st.spec_rounds, draft_proposed=st.draft_proposed,
        draft_accepted=st.draft_accepted, same=same)


def serve_phase():
    cfg = TT.TransformerConfig(**SERVE_CFG)
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    log(f"phase serve: {SERVE_CFG}, f32, slots={SLOTS} max_len={MAX_LEN} "
        f"page={PAGE}, {N_REQ} requests x {PROMPT}-token prompts "
        f"({N_REQ // 2} share a {SHARED}-token prefix), max_new={MAX_NEW}")
    params = TT.init_params(np.random.RandomState(0), cfg, device="cuda")
    qparams = Q.quantize_params(params)
    prompts = make_prompts()
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)

    # warm the kernels and the allocator outside the measured runs
    for c, p in ((cfg, params), (cfg8, params), (cfg, qparams)):
        DecodeEngine(p, c, **geom).serve(prompts[:2], max_new=4)
        DecodeEngine(p, dataclasses.replace(c, attn_impl="dense"),
                     ragged_impl="torch", **geom).serve(prompts[:2],
                                                        max_new=4)
    DecodeEngine(params, cfg, **geom).serve(prompts[:2], max_new=4,
                                            speculative=True)

    out, launches = {}, {}
    launches["float"], ptoks, out["float_kv"] = kernel_and_plain(
        "float KV", params, cfg, prompts,
        ("flash_fwd", "ragged_tq1", "ragged_tqn", "float_device"))
    # sampled requests draw from per-slot CUDA generators: the same
    # seeds must give the same tokens
    samp = [{"temperature": 0.8, "top_k": 50, "seed": i} for i in range(4)]
    drawn = [DecodeEngine(params, cfg, **geom).serve(
        prompts[:4], max_new=16, sampling=samp) for _ in range(2)]
    if drawn[0] != drawn[1]:
        raise Fail("sampled serving is not deterministic per seed")
    log(f"  sampled serving: 4 requests, seed-deterministic, "
        f"{len({t for r in drawn[0] for t in r})} distinct tokens")
    # the engine's consistency contract, against the plain generate()
    for i in (0, 1):
        ref = TT.generate(params, plain_cfg,
                          torch.from_numpy(prompts[i])[None].cuda(),
                          MAX_NEW)[0, PROMPT:].tolist()
        if ref != ptoks[i]:
            raise Fail(f"plain engine differs from generate() on request "
                       f"{i}")

    launches["int8_kv"], _, out["int8_kv"] = kernel_and_plain(
        "int8 KV", params, cfg8, prompts,
        ("flash_fwd", "int8_tq1", "int8_tqn", "int8_device"))
    launches["int8_weights"], _, out["int8_weights"] = kernel_and_plain(
        "int8 weights", qparams, cfg, prompts[:N_WEIGHT_REQ],
        ("flash_fwd", "ragged_tq1", "ragged_tqn", "float_device"))

    spec_prompts = make_spec_prompts(N_SPEC_REQ)
    launches["spec_float"], out["spec_float_kv"] = \
        speculative_vs_plain_decode("speculative, float KV", params, cfg,
                                    spec_prompts, "ragged_tqn")
    launches["spec_int8"], out["spec_int8_kv"] = \
        speculative_vs_plain_decode("speculative, int8 KV", params, cfg8,
                                    spec_prompts, "int8_tqn")
    return launches, out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    log("phase build")
    t0 = time.perf_counter()
    built = _cuda.build_all()
    log(f"  built {sorted(built) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _cuda.SOURCES:
        for line in _cuda.build_log(name).splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  {name}: {line.strip()}")

    hmma = flash_hmma_counts()
    walk_res = walk_resources_check()
    a, b, c = kernels_phase()
    lstm = lstm_kernels_phase()
    gru, rnn = gru_rnn_kernels_phase()
    wide = wide_phase()
    launched, serve = serve_phase()
    train = train_phase()
    ragged = ragged_phase()
    s2s, trained, batch0 = seq2seq_phase()
    gen = generation_phase(trained, batch0)
    srnn = simple_rnn_phase()
    lm = lm_train_phase()
    image = image_phase()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else "nvidia-smi: no output")

    def entry(name, source, replaces, launches, case, **extra):
        # the time loops' (D-I) tolerance holds rel_err: dW sums T*B terms
        held = "rel_err" if "rel_err" in extra else "max_abs_err"
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, **extra,
                "max_abs_err": case["err"], "tolerance": case["tol"],
                "tolerance_holds": held,
                "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]}

    def redesigned(case, calls, device):
        # E, G and I: the device launches of the main path's run (counted by
        # the wrapper as it launches each phase) and per call, the phase
        # split, and whether a second call repeated every output bit for
        # bit
        return {"device_launches": device,
                "device_launches_per_call": device / calls,
                "phases_ms": case["phases_ms"], "bitwise": case["bitwise"]}

    def split_plan(case, serve, kind):
        # the walk's device launches in that serve's run, per call at the
        # case's shape, its plan, and whether it repeated bit for bit
        return {"device_launches_in_serve": launched[serve][kind],
                "device_launches_per_call": case["device_launches_per_call"],
                "splits": case["splits"], "span_keys": case["span_keys"],
                "blocks": case["blocks"], "bitwise": case["bitwise"],
                "resources": {k: v for k, v in walk_res.items()
                              if k.startswith("C" if kind == "int8_device"
                                              else "B")}}

    # launches: A and B from the float serve, C from the int8-KV serve,
    # each counted from 0 just before that run
    walk = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
    kernels = [
        entry("flash_attention_fwd",
              "paddle_tpu_torch/csrc/flash_attention.cu",
              "paddle_tpu/ops/flash_attention.py:45",
              launched["float"]["flash_fwd"], a["main_prefill_t128"],
              hmma_per_instantiation=hmma,
              # the LM train phase's three full-width variants, counted
              # from 0 before each (a forward and a remat recompute per
              # layer per step)
              lm_train_launches=lm["a_launches"],
              lm_train_launches_per_step=lm["a_launches_per_step"],
              other_shapes={k: {f: a[k][f] for f in (
                  "ms", "library_ms", "bound_ms", "err", "row_rel_err")
                  if f in a[k]} for k in (
                  "causal_t2048_float32", "causal_t2048_bfloat16",
                  "causal_t8192_bf16", "causal_t8192_f32",
                  "window1024_t8192_f32", "hd128_float32",
                  "hd128_bfloat16",
                  "scaled_scores_float32")}),
        # B and C: calls of the float and int8-KV serves' runs; their
        # device launches in those runs (the split walk, and the combine
        # where the plan has several splits), per call at the case's
        # shape, and the plan
        entry("ragged_paged_walk[tq=1]", walk,
              "paddle_tpu/ops/ragged_paged_attention.py:153",
              launched["float"]["ragged_tq1"], b["main_decode"],
              **split_plan(b["main_decode"], "float", "float_device")),
        entry("ragged_paged_walk[tq>1]", walk,
              "paddle_tpu/ops/ragged_paged_attention.py:153",
              launched["float"]["ragged_tqn"], b["main_chunk"],
              **split_plan(b["main_chunk"], "float", "float_device")),
        entry("ragged_paged_walk_int8[tq=1]", walk,
              "paddle_tpu/ops/ragged_paged_attention.py:188",
              launched["int8_kv"]["int8_tq1"], c["main_decode"],
              **split_plan(c["main_decode"], "int8_kv", "int8_device")),
        entry("ragged_paged_walk_int8[tq>1]", walk,
              "paddle_tpu/ops/ragged_paged_attention.py:188",
              launched["int8_kv"]["int8_tqn"], c["main_chunk"],
              **split_plan(c["main_chunk"], "int8_kv", "int8_device")),
        # D and E: launches of the train phase's run (2 of each per step)
        # (their tolerance holds rel_err, max abs error over max |plain|)
        entry("lstm_fwd", "paddle_tpu_torch/csrc/fused_lstm.cu",
              "paddle_tpu/ops/pallas_lstm.py:58", train["launches"]["D"],
              lstm["main"]["D"],
              launches_per_train_step=train["launches"]["D"] / TRAIN_STEPS,
              rel_err=lstm["main"]["D"]["rel_err"],
              device_launches=train["device_launches"]["D"],
              device_launches_per_call=(train["device_launches"]["D"]
                                        / train["launches"]["D"]),
              us_per_step=lstm["main"]["D"]["us_per_step"],
              bitwise=lstm["main"]["D"]["bitwise"]),
        entry("lstm_bwd", "paddle_tpu_torch/csrc/fused_lstm.cu",
              "paddle_tpu/ops/pallas_lstm.py:86", train["launches"]["E"],
              lstm["main"]["E"],
              launches_per_train_step=train["launches"]["E"] / TRAIN_STEPS,
              rel_err=lstm["main"]["E"]["rel_err"],
              **redesigned(lstm["main"]["E"], train["launches"]["E"],
                           train["device_launches"]["E"])),
        # F and G: launches of the seq2seq phase's run (2 of each per
        # step); H and I: of the simple_rnn phase's forward and backward
        entry("gru_fwd", "paddle_tpu_torch/csrc/fused_gru.cu",
              "paddle_tpu/ops/pallas_gru.py:37", s2s["launches"]["F"],
              gru["main"]["F"],
              launches_per_train_step=s2s["launches"]["F"] / TRAIN_STEPS,
              rel_err=gru["main"]["F"]["rel_err"],
              device_launches=s2s["device_launches"]["F"],
              device_launches_per_call=(s2s["device_launches"]["F"]
                                        / s2s["launches"]["F"]),
              bitwise=gru["main"]["F"]["bitwise"]),
        entry("gru_bwd", "paddle_tpu_torch/csrc/fused_gru.cu",
              "paddle_tpu/ops/pallas_gru.py:59", s2s["launches"]["G"],
              gru["main"]["G"],
              launches_per_train_step=s2s["launches"]["G"] / TRAIN_STEPS,
              rel_err=gru["main"]["G"]["rel_err"],
              **redesigned(gru["main"]["G"], s2s["launches"]["G"],
                           s2s["device_launches"]["G"])),
        entry("rnn_fwd", "paddle_tpu_torch/csrc/fused_rnn.cu",
              "paddle_tpu/ops/pallas_rnn.py:26", srnn["launches"]["H"],
              rnn["main"]["H"], launches_per_train_step=srnn["launches"]["H"],
              rel_err=rnn["main"]["H"]["rel_err"],
              device_launches=srnn["device_launches"]["H"],
              device_launches_per_call=(srnn["device_launches"]["H"]
                                        / srnn["launches"]["H"]),
              us_per_step=rnn["main"]["H"]["us_per_step"],
              bitwise=rnn["main"]["H"]["bitwise"]),
        entry("rnn_bwd", "paddle_tpu_torch/csrc/fused_rnn.cu",
              "paddle_tpu/ops/pallas_rnn.py:44", srnn["launches"]["I"],
              rnn["main"]["I"], launches_per_train_step=srnn["launches"]["I"],
              rel_err=rnn["main"]["I"]["rel_err"],
              **redesigned(rnn["main"]["I"], srnn["launches"]["I"],
                           srnn["device_launches"]["I"])),
    ]
    log(json.dumps({"launches": launched}))
    log(json.dumps({"serve": serve}))
    log(json.dumps({"train": train, "ragged": ragged}))
    log(json.dumps({"seq2seq": s2s, "generation": gen,
                    "simple_rnn": srnn}))
    log(json.dumps({"wide_cases": wide}))
    log(json.dumps({"lm_train": lm, "card": smi.stdout.strip()}))
    log(json.dumps({"image": image, "card": smi.stdout.strip()}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Fail as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
