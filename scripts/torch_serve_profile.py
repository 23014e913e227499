#!/usr/bin/env python3
"""Where a serving step's time goes in the PyTorch/CUDA port, on one card.

    python3 scripts/torch_serve_profile.py [--kv-cache-dtype int8]

Builds the chip smoke's serving configuration (vocab 32000, dim 512, 8
layers, 8 heads, f32, DecodeEngine slots=8 max_len=256 page_size=16,
seeded random weights; KV pool in the compute dtype, or int8 (s8,
scale) arenas read through the int8 walk), fills all 8 slots with
128-token prompts, then:

- times 64 decode steps on the host clock (each ends in the host sync
  the serve loop does anyway), unprofiled: ms per step;
- profiles 16 decode steps with torch.profiler (CPU + CUDA activity):
  the device-busy share of the window (union of kernel intervals over
  wall time), and device time by kernel and by kind;
- times one 128-token from-zero prefill and one 64-token prefix-hit
  chunk on the host clock.

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

from paddle_tpu_torch.models import transformer as TT  # noqa: E402
from paddle_tpu_torch.serve.engine import DecodeEngine  # noqa: E402

CFG = dict(vocab=32000, dim=512, n_layers=8, n_heads=8)
SLOTS, MAX_LEN, PAGE, PROMPT, SHARED = 8, 256, 16, 128, 64


def kind(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("ragged_walk", "split_walk", "combine_kernel")):
        return "ragged walk kernel"   # float and int8 arenas alike
    if "flash_fwd" in n:
        return "flash kernel"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "xmma" in n:
        return "matmul"
    if "index" in n or "scatter" in n or "gather" in n:
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


def step(eng, state):
    state, toks, lps, act, fin = eng.decode_step(state)
    torch.stack([toks.double(), lps.double()]).cpu()     # the serve sync
    return state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kv-cache-dtype", choices=("compute", "int8"),
                    default="compute")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TT.TransformerConfig(**CFG, kv_cache_dtype=args.kv_cache_dtype)
    params = TT.init_params(np.random.RandomState(0), cfg, device="cuda")
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, CFG["vocab"], PROMPT).astype(np.int32)
               for _ in range(SLOTS)]
    eng = DecodeEngine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                       page_size=PAGE)
    state = eng.init_state()
    for s, p in enumerate(prompts):
        state = eng.prefill(state, s, p)
    for _ in range(4):
        state = step(eng, state)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(64):
        state = step(eng, state)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 64 * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            state = step(eng, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_kind = defaultdict(lambda: [0.0, 0]), defaultdict(float)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
        by_kind[kind(e.name)] += dur
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels])
    print(f"card: {torch.cuda.get_device_name(0)}, KV pool "
          f"{args.kv_cache_dtype}")
    print(f"decode step (8 slots, unprofiled): {step_ms:.3f} ms")
    if kernels:
        print(f"profiled 16 steps: wall {wall_us / 1e3:.3f} ms, device busy "
              f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
              f"{len(kernels) / 16:.0f} kernels per step")
        for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"  {k:<20} {v / 16:9.1f} us/step")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        for name, (t, n) in top:
            print(f"  {t / 16:9.1f} us/step  x{n / 16:5.1f}  {name[:90]}")
    else:
        print("profiler recorded no device activity: device busy share "
              "not measured")

    # prefill: a from-zero 128-token prompt, then a 64-token prefix hit
    for s in range(SLOTS):
        state = eng.release_slot(state, s)
    shared = rs.randint(0, CFG["vocab"], SHARED)
    p1 = np.concatenate([shared, rs.randint(0, CFG["vocab"], SHARED)])
    p2 = np.concatenate([shared, rs.randint(0, CFG["vocab"], SHARED)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = eng.prefill(state, 0, p1.astype(np.int32))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = eng.prefill(state, 1, p2.astype(np.int32))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = {"card": torch.cuda.get_device_name(0),
           "kv_cache_dtype": args.kv_cache_dtype, "decode_step_ms": step_ms,
           "device_busy_share": (busy_us / wall_us if kernels else None),
           "kernels_per_step": len(kernels) / 16,
           "device_us_per_step_by_kind": {k: v / 16
                                          for k, v in by_kind.items()},
           "prefill_from_zero_128_ms": (t1 - t0) * 1e3,
           "prefill_prefix_hit_chunk_64_ms": (t2 - t1) * 1e3,
           "prefix_hits": eng.pool.prefix_hits}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
