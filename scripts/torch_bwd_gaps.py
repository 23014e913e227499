#!/usr/bin/env python3
"""The launches of one call of kernel E (csrc/fused_lstm.cu, the LSTM
backward), of kernel G (csrc/fused_gru.cu, the GRU backward) and of
kernel I (csrc/fused_rnn.cu, the tanh-RNN backward) on the card, and the
gaps between them, from a torch.profiler trace.

    python3 scripts/torch_bwd_gaps.py [--calls 10]

E and I at bench_lstm's shape (T=100, B=64, H=512) and G at the seq2seq
encoder's (T=30, B=64, H=512), f32, full lengths, seeded random inputs.
Before each call the L2 is flushed and the GPU spins while the host
queues the whole call, so each gap (end of one launch to the start of
the next, on the device's clock) is the card's own cost of a launch
boundary, not host time. The launches of a call are counted by the
wrapper (`device_launches`); I's include the memset that zeroes its
loop's barrier counters (E and G zero theirs in their gates kernel), a
device operation of the trace's own kind (`gpu_memset`), matched here
beside the kernels. Prints one JSON line per kernel: the mean
device ms of each launch, the mean gap after each but the last in
microseconds, their sum, and the call's span from the first launch's
start to the last one's end. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.ops import _cuda  # noqa: E402
from paddle_tpu_torch.ops import fused_gru as FG  # noqa: E402
from paddle_tpu_torch.ops import fused_lstm as FL  # noqa: E402
from paddle_tpu_torch.ops import fused_rnn as FR  # noqa: E402

# the names of E's, G's and I's launches in a trace
PHASES = ("bwd_gates", "backward_loop_kernel", "dw_kernel", "reduce_splits")
# I's counters' memset: a memset far smaller than the L2 flush's buffer
SMALL_MEMSET = 1 << 20
SPIN_CYCLES = 10_000_000


def inputs(gates, t, b, h, seed=0):
    """x_proj [T, B, gates*H] N(0, 1), w_hh uniform(+-1/sqrt(H)), zero
    initial state, full lengths; then the plain forward's outputs and
    random cotangents: the backward kernel's arguments."""
    rs = np.random.RandomState(seed)
    f32 = lambda *s: torch.from_numpy(
        rs.standard_normal(s).astype(np.float32)).cuda()
    lim = 1.0 / np.sqrt(h)
    xp = f32(t, b, gates * h)
    w = torch.from_numpy(rs.uniform(-lim, lim, (h, gates * h)).astype(
        np.float32)).cuda()
    z = torch.zeros(b, h, device="cuda")
    bounds = FL.make_bounds(b, t, None, False, device="cuda")
    if gates == 4:
        args = (xp, w, z, z, bounds)
        return args + FL.lstm_forward_reference(*args) + (
            f32(t, b, h), f32(b, h), f32(b, h))
    args = (xp, w, z, bounds)
    fwd = FG.gru_forward_reference if gates == 3 else \
        FR.rnn_forward_reference
    return args + (fwd(*args), f32(t, b, h), f32(b, h))


def ours(e):
    """Is trace event e a launch of E, G or I?"""
    if e.get("ph") != "X":
        return False
    if e.get("cat") == "gpu_memset":
        return e.get("args", {}).get("bytes", 0) < SMALL_MEMSET
    return e.get("cat") == "kernel" and any(p in e["name"] for p in PHASES)


def measure(module, bwd, bargs, calls):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        bwd(*bargs)
    torch.cuda.synchronize()
    module.reset_launch_counts()
    bwd(*bargs)
    per_call = module.device_launches["bwd"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            bwd(*bargs)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    found = sorted(filter(ours, trace["traceEvents"]), key=lambda e: e["ts"])
    if len(found) != calls * per_call:
        raise RuntimeError(f"{len(found)} launches in the trace, want "
                           f"{calls} calls x {per_call}")
    runs = [found[i:i + per_call] for i in range(0, len(found), per_call)]
    dur = np.array([[e["dur"] for e in r] for r in runs], dtype=np.float64)
    gap = np.array([[b["ts"] - (a["ts"] + a["dur"])
                     for a, b in zip(r, r[1:])] for r in runs],
                   dtype=np.float64)
    span = np.array([r[-1]["ts"] + r[-1]["dur"] - r[0]["ts"] for r in runs],
                    dtype=np.float64)
    names = [e["name"].split("(")[0][:80] for e in runs[0]]
    return {"device_launches_per_call": per_call, "launches": names,
            "launch_ms": list(dur.mean(axis=0) / 1e3),
            "gap_us": list(gap.mean(axis=0)),
            "gap_us_sum": float(gap.sum(axis=1).mean()),
            "gap_us_max": float(gap.max()),
            "call_span_ms": float(span.mean() / 1e3), "calls": calls}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=10)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bwd_gaps: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build_all(["fused_lstm", "fused_gru", "fused_rnn"])
    for kern, module, bwd, shape in (
            ("E", FL, FL.lstm_backward_kernel, (4, 100, 64, 512)),
            ("G", FG, FG.gru_backward_kernel, (3, 30, 64, 512)),
            ("I", FR, FR.rnn_backward_kernel, (1, 100, 64, 512))):
        out = measure(module, bwd, inputs(*shape), a.calls)
        print(json.dumps({"kernel": kern, "T": shape[1], "B": shape[2],
                          "H": shape[3], **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
