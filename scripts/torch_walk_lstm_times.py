#!/usr/bin/env python3
"""Device and host times of kernels B and C (the ragged walk over float
and int8 arenas), D (the LSTM forward time loop) and H (the tanh-RNN
forward time loop) at their main shapes, and the per-step cost of the
forward loops D, F and H, for comparing two checkouts on one card.

    cd <checkout> && python3 <this checkout>/scripts/torch_walk_lstm_times.py

It imports `chip_smoke` and `paddle_tpu_torch` from the working
directory, so the same script times any checkout's kernels: run it from
the parent's and from the change's root in turns (parent, change,
change, parent) within one call. It prints the chip smoke's lines for
B and C at decode (R=8, TQ=1, H=Hkv=8, Dh=64, f32) and at the TQ=64
prefix chunk, for D and E at bench_lstm's T=100, B=64, H=512 beside
cuDNN's LSTM, and for H and I at the same shape beside cuDNN's
`nn.RNN(512, 512, tanh)`; then the host time of one call, enqueued
without a sync: B at decode (2000 calls; the card keeps pace), D and H
(20 calls, far from the launch queue's depth); H's device time at B=100,
H=2560, T=20 (a shape the one-launch H held in shared memory and the
forward loop reads from L2). Last, the forward loops'
cost per step at B=64, H=512 f32, full lengths: each of D (4 gate
columns), F (3) and H (1) timed at T=50 and T=100 (L2 flushed, as the
smoke times), the slope (ms(100) - ms(50)) / 50 leaving out what a call
pays once (the launch, the memset, loading w_hh's columns). The last
line is one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as S  # noqa: E402
from paddle_tpu_torch.ops import fused_gru as FG  # noqa: E402
from paddle_tpu_torch.ops import fused_lstm as FL  # noqa: E402
from paddle_tpu_torch.ops import fused_rnn as FR  # noqa: E402
from paddle_tpu_torch.ops import ragged_paged_attention as RPA  # noqa: E402


def host_us(fn, calls):
    """Host microseconds per call of fn, enqueued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def loop_inputs(gates, t, b=64, h=512, seed=0):
    """x_proj [T, B, gates*H] N(0, 1), w_hh uniform(+-1/sqrt(H)), h0 zero,
    full lengths (D also gets c0): the arguments of a forward loop."""
    rs = np.random.RandomState(seed)
    xp = torch.from_numpy(rs.standard_normal((t, b, gates * h)).astype(
        np.float32)).cuda()
    lim = 1.0 / np.sqrt(h)
    w = torch.from_numpy(rs.uniform(-lim, lim, (h, gates * h)).astype(
        np.float32)).cuda()
    state = (torch.zeros(b, h, device="cuda"),) * (2 if gates == 4 else 1)
    return (xp, w) + state + (FL.make_bounds(b, t, None, False,
                                             device="cuda"),)


def step_costs():
    """{kernel: (ms at T=50, ms at T=100, us per step from the slope)} of
    the forward loops D, F and H at B=64, H=512 f32."""
    out = {}
    for kern, fwd, gates in (("D", FL.lstm_forward_kernel, 4),
                             ("F", FG.gru_forward_kernel, 3),
                             ("H", FR.rnn_forward_kernel, 1)):
        ms = []
        for t in (50, 100):
            args = loop_inputs(gates, t)
            ms.append(S.time_ms(lambda: fwd(*args)))
        out[kern] = (ms[0], ms[1], (ms[1] - ms[0]) / 50 * 1e3)
        print(f"{kern}: {gates} gate column(s), T=50 {ms[0]:.4f} ms, T=100 "
              f"{ms[1]:.4f} ms: {out[kern][2]:.3f} us per step",
              flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": torch.cuda.get_device_name(0)}
    for k, kw in (("decode", dict(r=8, tq=1, h=8, hkv=8)),
                  ("chunk", dict(r=1, tq=64, h=8, hkv=8, pos0=S.SHARED))):
        out["B_" + k] = S.ragged_case("main_" + k, **kw)["ms"]
        out["C_" + k] = S.ragged_case("main_" + k, int8=True, **kw)["ms"]
    d = S.lstm_case("main_full_f32", library=True)
    out.update(D=d["D"]["ms"], cudnn_fwd=d["D"]["library_ms"],
               E=d["E"]["ms"])
    r = S.time_loop_case(S.RNN_LOOP, "HI", "main_full_f32", library=(
        torch.nn.RNN(512, 512, nonlinearity="tanh"), 512), t=100, b=64,
        h=512)
    out.update(H=r["H"]["ms"], cudnn_rnn_fwd=r["H"]["library_ms"],
               I=r["I"]["ms"])

    rs = np.random.RandomState(0)
    mk = lambda *s: torch.from_numpy(
        rs.standard_normal(s).astype(np.float32)).cuda()
    q, ka, va = mk(8, 1, 8, 64), mk(128, 16, 8, 64), mk(128, 16, 8, 64)
    pt = torch.from_numpy(np.stack([rs.permutation(128)[:16]
                                    for _ in range(8)]).astype(np.int32))
    pos0 = torch.full((8,), 200, dtype=torch.int32, device="cuda")
    act = torch.ones(8, dtype=torch.bool, device="cuda")
    walk = (q, ka, va, pt.cuda(), pos0, act)
    out["B_decode_host_us"] = host_us(
        lambda: RPA.ragged_kernel(*walk, page_size=16, max_len=256), 2000)
    args, _ = S.lstm_case_inputs(t=100, b=64, h=512, dtype=torch.float32,
                                 lengths=False, reverse=False,
                                 initial=False, seed=0)
    out["D_host_us"] = host_us(lambda: FL.lstm_forward_kernel(*args), 20)
    h_args = loop_inputs(1, 100)
    out["H_host_us"] = host_us(lambda: FR.rnn_forward_kernel(*h_args), 20)
    wide = loop_inputs(1, 20, b=100, h=2560)
    out["H_b100_h2560_t20"] = S.time_ms(lambda: FR.rnn_forward_kernel(*wide))
    out["step_costs"] = step_costs()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
