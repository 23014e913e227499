#!/usr/bin/env python3
"""Does torch's CUDA avg_pool2d backward agree with the CPU's on
channels_last memory?

    python3 scripts/torch_avg_pool_check.py

`ops/conv.avg_pool2d` hands `F.avg_pool2d` no padding (it pads with
`F.pad` first) because, with torch 2.11.0+cu128 on an H100, the CUDA
backward over channels_last memory is wrong whenever the op pads. This
script holds `F.avg_pool2d`'s forward and input gradient on the card,
over NCHW and channels_last memory, against the CPU's, for windows 2
and 3, strides 1 and 2, padding 0 and 1, count_include_pad both ways
and divisor_override None or 1, on seeded f32 inputs [2, 32, 16, 16]
and cotangents; the error is max abs error over max |CPU|. Prints one
JSON line per case, then torch's version and the card's name and power
limit. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F


def rel(a, b):
    return ((a.double().cpu() - b.double().cpu()).abs().max()
            / b.double().abs().max()).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_avg_pool_check: no CUDA device", file=sys.stderr)
        return 2
    x0 = np.random.RandomState(0).standard_normal(
        (2, 32, 16, 16)).astype(np.float32)
    for k, s, p, cip, div in itertools.product(
            (3, 2), (2, 1), (0, 1), (True, False), (None, 1)):
        out = {}
        for dev, fmt in (("cpu", torch.contiguous_format),
                         ("cuda", torch.contiguous_format),
                         ("cuda", torch.channels_last)):
            t = torch.from_numpy(x0).to(dev).contiguous(
                memory_format=fmt).requires_grad_()
            y = F.avg_pool2d(t, k, s, padding=p, count_include_pad=cip,
                             divisor_override=div)
            g = torch.from_numpy(np.random.RandomState(1).standard_normal(
                tuple(y.shape)).astype(np.float32)).to(dev)
            (gx,) = torch.autograd.grad(y, [t], g)
            out[(dev, fmt)] = (y.detach(), gx)
        ref = out[("cpu", torch.contiguous_format)]
        nchw = out[("cuda", torch.contiguous_format)]
        cl = out[("cuda", torch.channels_last)]
        print(json.dumps(dict(
            window=k, stride=s, padding=p, count_include_pad=cip,
            divisor_override=div, nchw_y=rel(nchw[0], ref[0]),
            nchw_dx=rel(nchw[1], ref[1]), channels_last_y=rel(cl[0], ref[0]),
            channels_last_dx=rel(cl[1], ref[1]))), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"torch {torch.__version__}; {smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
