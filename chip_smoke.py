#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (paddle_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build  -- compile every CUDA kernel of the serving path from
   paddle_tpu_torch/csrc (one nvcc per source, all at once).
2. kernels -- hold each kernel against its plain PyTorch version on the
   card, case by case, and time both (CUDA events around device work
   only, L2 flushed before every call, as a serving step finds it
   cold), beside the least time the card could take (`bound_ms`) and,
   for flash attention,
   `torch.nn.functional.scaled_dot_product_attention` as a yardstick.
   Tolerances: float32 1e-4, bfloat16 2e-2, on outputs of unit scale.
3. serve  -- the transformer LM at the serving benchmark's width (vocab
   32000, dim 512, 8 layers, 8 heads, f32) with seeded random weights
   serves 32 requests (128-token prompts, half sharing a 64-token
   prefix, 128 new tokens) through DecodeEngine(slots=8, max_len=256,
   page_size=16). Every kernel must have launched in that run. The same
   requests then go through the plain path (dense attention, the ragged
   walk's plain version) and the greedy tokens must agree; where they
   differ, the plain path's top-2 logit gap at the first differing step
   must be <= 1e-3 (a near tie, not a fault). Four sampled requests
   must repeat their tokens under the same seeds, and the plain engine
   must match generate() on two requests.
4. report -- the card's name and power limit, a `kernels` JSON line,
   and last the device JSON line.

TF32 is switched off for matmuls and cuDNN, so float32 means float32.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.ops import flash_attention as FA
from paddle_tpu_torch.ops import ragged_paged_attention as RPA
from paddle_tpu_torch.serve.engine import DecodeEngine

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12,           # f32, CUDA cores
              torch.bfloat16: 989e12}         # bf16, dense tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GAP_LIMIT = 1e-3

SERVE_CFG = dict(vocab=32000, dim=512, n_layers=8, n_heads=8)
SLOTS, MAX_LEN, PAGE = 8, 256, 16
N_REQ, PROMPT, SHARED, MAX_NEW = 32, 128, 64, 128


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


def bound(bytes_, flops, dtype):
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- kernel B: the ragged page-table walk ------------------------------------


def ragged_case(name, *, r, tq, h, hkv, dh=64, dtype=torch.float32,
                pos0=None, inactive=0, sentinel_tail=0, seed=0):
    rs = np.random.RandomState(seed)
    max_pages = -(-MAX_LEN // PAGE)
    num_pages = max(r, SLOTS) * max_pages
    dev = "cuda"
    mk = lambda *s: torch.from_numpy(
        rs.standard_normal(s).astype(np.float32)).to(dev, dtype)
    q = mk(r, tq, h, dh)
    ka = mk(num_pages, PAGE, hkv, dh)
    va = mk(num_pages, PAGE, hkv, dh)
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
    got = RPA.ragged_kernel(*args, **kw)
    ref = RPA.ragged_reference(*args, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    # the work this data needs: active rows attend keys <= pos0 + i, an
    # inactive row all max_len keys
    isz = q.element_size()
    keys_q = np.where(active[:, None],
                      np.minimum(pos0[:, None] + np.arange(tq) + 1, MAX_LEN),
                      MAX_LEN)                                # [R, TQ]
    keys_row = keys_q.max(axis=1)
    bytes_ = (2 * q.numel() * isz + 2 * keys_row.sum() * hkv * dh * isz
              + pt.nbytes + pos0.nbytes + active.nbytes)
    flops = 4 * dh * h * keys_q.sum()
    bound_ms, bound_by = bound(bytes_, flops, dtype)
    k_ms = time_ms(lambda: RPA.ragged_kernel(*args, **kw))
    p_ms = time_ms(lambda: RPA.ragged_reference(*args, **kw))
    ok = err <= TOL[dtype]
    log(f"  B {name:<22} {str(dtype)[6:]:<8} err {err:.2e} "
        f"(tol {TOL[dtype]:.0e}) kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
        f"bound_ms {bound_ms:.4f} ({bound_by}) {'ok' if ok else 'FAIL'}")
    return dict(name=name, err=err, ok=ok, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                tol=TOL[dtype])


# -- kernel A: flash attention forward ---------------------------------------


def flash_case(name, *, b, t, h, d=64, dtype=torch.float32, causal=True,
               lens=None, window=None, seed=0):
    rs = np.random.RandomState(seed)
    mk = lambda: torch.from_numpy(rs.standard_normal(
        (b, t, h, d)).astype(np.float32)).to("cuda", dtype)
    q, k, v = mk(), mk(), mk()
    lens_np = np.full(b, t) if lens is None else np.asarray(lens)
    lens_t = torch.from_numpy(lens_np.astype(np.int32)).to("cuda")
    kw = dict(causal=causal, window=window)
    o, lse = FA.flash_kernel(q, k, v, lens_t, **kw)
    o_ref, lse_ref = FA.flash_attention_reference(q, k, v, lens_t, **kw)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    live = lse_ref > -1e29
    lse_err = (lse - lse_ref)[live].abs().max().item() if live.any() else 0.0
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
    bound_ms, bound_by = bound(bytes_, flops, dtype)
    k_ms = time_ms(lambda: FA.flash_kernel(q, k, v, lens_t, **kw))
    p_ms = time_ms(lambda: FA.flash_attention_reference(q, k, v, lens_t,
                                                        **kw))
    lib_ms = None
    if causal and window is None and (lens_np == t).all():
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
    tol = TOL[dtype]
    # lse is f32 in both versions: hold it to f32's tolerance, relative
    # to its own scale (log-sum-exps grow with the scores)
    lse_scale = lse_ref[live].abs().max().item() if live.any() else 1.0
    ok = err <= tol and lse_err <= 1e-4 * max(1.0, lse_scale)
    lib = "-" if lib_ms is None else f"{lib_ms:.4f}"
    log(f"  A {name:<22} {str(dtype)[6:]:<8} err {err:.2e} lse_err "
        f"{lse_err:.2e} (tol {tol:.0e}) kernel_ms {k_ms:.4f} plain_ms "
        f"{p_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) library_ms {lib} "
        f"{'ok' if ok else 'FAIL'}")
    return dict(name=name, err=err, ok=ok, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                tol=tol)


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
    bad = [k for k, v in {**a, **b}.items() if not v["ok"]]
    if bad:
        raise Fail(f"kernel disagrees with its plain version: {bad}")
    return a, b


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


def reset_counts():
    FA.reset_launch_counts()
    RPA.reset_launch_counts()


def counts():
    return {"flash_fwd": FA.launch_counts["fwd"],
            "ragged_tq1": RPA.launch_counts["tq1"],
            "ragged_tqn": RPA.launch_counts["tqn"]}


def timed_serve(eng, prompts):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.serve(prompts, max_new=MAX_NEW)
    torch.cuda.synchronize()
    return toks, time.perf_counter() - t0


def serve_phase():
    cfg = TT.TransformerConfig(**SERVE_CFG)
    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    log(f"phase serve: {SERVE_CFG}, f32, slots={SLOTS} max_len={MAX_LEN} "
        f"page={PAGE}, {N_REQ} requests x {PROMPT}-token prompts "
        f"({N_REQ // 2} share a {SHARED}-token prefix), max_new={MAX_NEW}")
    params = TT.init_params(np.random.RandomState(0), cfg, device="cuda")
    prompts = make_prompts()
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)

    # warm the kernels and the allocator outside the measured runs
    DecodeEngine(params, cfg, **geom).serve(prompts[:2], max_new=4)
    DecodeEngine(params, plain_cfg, ragged_impl="torch",
                 **geom).serve(prompts[:2], max_new=4)

    eng = DecodeEngine(params, cfg, **geom)
    reset_counts()
    toks, wall = timed_serve(eng, prompts)
    launched = counts()
    stats = eng.last_stats
    n_tok = sum(len(t) for t in toks)
    log(f"  kernel path: {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} generated tokens/s; steps {stats.steps}, "
        f"prefix hits {stats.prefix_hits}, prefill chunks "
        f"{stats.prefill_chunks}, launches {launched}")
    missing = [k for k, v in launched.items() if v == 0]
    if missing:
        raise Fail(f"kernels never launched on the serving path: {missing}")
    if any(len(t) != MAX_NEW for t in toks):
        raise Fail("a request did not emit max_new tokens")
    if any(not (0 <= x < cfg.vocab) for t in toks for x in t):
        raise Fail("token out of vocabulary range")

    plain = DecodeEngine(params, plain_cfg, ragged_impl="torch", **geom)
    reset_counts()
    ptoks, pwall = timed_serve(plain, prompts)
    if any(counts().values()):
        raise Fail(f"the plain path launched kernels: {counts()}")
    log(f"  plain path:  {n_tok} tokens in {pwall:.3f} s = "
        f"{n_tok / pwall:.1f} generated tokens/s")

    same, worst_gap = 0, None
    for i, (a, b) in enumerate(zip(toks, ptoks)):
        if a == b:
            same += 1
            continue
        d = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.concatenate([prompts[i], np.asarray(b[:d], np.int32)])
        logits = TT.apply(params, plain_cfg,
                          torch.from_numpy(ctx)[None].cuda())[0, -1]
        top2 = torch.topk(logits.float(), 2).values
        gap = (top2[0] - top2[1]).item()
        worst_gap = gap if worst_gap is None else max(worst_gap, gap)
        log(f"  request {i}: first differing step {d}: kernel {a[d]} vs "
            f"plain {b[d]}, plain top-2 logit gap {gap:.3e}")
    log(f"  greedy tokens equal on {same}/{N_REQ} requests")
    if worst_gap is not None and worst_gap > GAP_LIMIT:
        raise Fail(f"greedy tokens differ at a top-2 gap {worst_gap:.3e} > "
                   f"{GAP_LIMIT}")
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
    return launched, dict(tokens=n_tok, wall_s=wall, tok_s=n_tok / wall,
                          plain_wall_s=pwall, plain_tok_s=n_tok / pwall,
                          same=same, steps=stats.steps,
                          prefix_hits=stats.prefix_hits)


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
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    a, b = kernels_phase()
    launched, serve = serve_phase()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else "nvidia-smi: no output")

    def entry(name, source, replaces, launches, case):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": case["err"], "tolerance": case["tol"],
                "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]}

    kernels = [
        entry("flash_attention_fwd",
              "paddle_tpu_torch/csrc/flash_attention.cu",
              "paddle_tpu/ops/flash_attention.py:45", launched["flash_fwd"],
              a["main_prefill_t128"]),
        entry("ragged_paged_walk[tq=1]",
              "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
              "paddle_tpu/ops/ragged_paged_attention.py:153",
              launched["ragged_tq1"], b["main_decode"]),
        entry("ragged_paged_walk[tq>1]",
              "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
              "paddle_tpu/ops/ragged_paged_attention.py:153",
              launched["ragged_tqn"], b["main_chunk"]),
    ]
    log(json.dumps({"serve": serve}))
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
