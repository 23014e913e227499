#!/usr/bin/env python3
"""Where a step of the forward time loop goes: kernels D (LSTM, 4 gate
columns), F (GRU, 3) and H (tanh RNN, 1), all on `csrc/time_loop.cuh
forward_loop_kernel`, timed as built and with parts of the step removed.

    python3 scripts/torch_forward_loop_parts.py

Builds `fused_lstm.cu`, `fused_gru.cu` and `fused_rnn.cu` once per
variant, each from a copy of `csrc/` under the build directory whose
`time_loop.cuh` is edited (the committed kernels have no switches):
- as_built: unchanged;
- no_products: the carry product's weight loads and FMAs removed (the
  operand is still staged, the sums reduced);
- no_staging: the cp.async copies of the operand's chunks removed (the
  products read what shared memory holds);
- no_barrier: the row group's barrier after each step replaced by a
  block barrier;
- cell_only: all three removed.
Results are wrong in every variant but as_built; the times tell where a
step goes. An edit whose anchor is not found exactly once fails the run.
One nvcc per build, all started together. Each kernel runs through its
wrapper (the variant's library in place of the built one) at B=64,
H=512, f32, full lengths, T=50 and T=100 (device time with the L2 flushed
before each call, as `chip_smoke.time_ms`); the slope (ms(100) - ms(50))
/ 50 is the cost of one step without what a call pays once. Prints one
JSON line per variant, then the card's name and power limit. Needs a
CUDA device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from paddle_tpu_torch.ops import _cuda  # noqa: E402
from paddle_tpu_torch.ops import fused_gru as FG  # noqa: E402
from paddle_tpu_torch.ops import fused_lstm as FL  # noqa: E402
from paddle_tpu_torch.ops import fused_rnn as FR  # noqa: E402
from torch_walk_lstm_times import loop_inputs  # noqa: E402

OUT = _cuda.BUILD_DIR / "loop_parts"
# the parts of a step that a variant removes: (anchor, replacement)
REMOVE = {
    "products": ("    for (int c = lane * 4; c < w; c += kN * 4) {\n",
                 "    for (int c = lane * 4; c < 0; c += kN * 4) {\n"),
    "staging": ("      cp_async16(dst + r * lds + v * kVec,\n"
                "                 src + (size_t)b * ldo + c0 + v * kVec);\n",
                ""),
    "barrier": ("    group_barrier(count, (unsigned)(s * n_units));\n  }\n}",
                "    __syncthreads();\n  }\n}"),
}
VARIANTS = {"as_built": (), "no_products": ("products",),
            "no_staging": ("staging",), "no_barrier": ("barrier",),
            "cell_only": ("products", "staging", "barrier")}
# kernel -> (library, wrapper module, forward wrapper, its plain
# version, gate columns)
KERNELS = {"D": ("fused_lstm", FL, FL.lstm_forward_kernel,
                 FL.lstm_forward_reference, 4),
           "F": ("fused_gru", FG, FG.gru_forward_kernel,
                 FG.gru_forward_reference, 3),
           "H": ("fused_rnn", FR, FR.rnn_forward_kernel,
                 FR.rnn_forward_reference, 1)}
STEPS = (50, 100)


def edited_header(parts):
    src = (_cuda.CSRC_DIR / "time_loop.cuh").read_text()
    for part in parts:
        anchor, repl = REMOVE[part]
        if src.count(anchor) != 1:
            raise RuntimeError(f"{part}: anchor not found once")
        src = src.replace(anchor, repl)
    return src


def build_all():
    """{variant: {library: loaded library or the compiler's error}}"""
    procs = {}
    for variant, parts in VARIANTS.items():
        d = OUT / variant
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for header in _cuda.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / "time_loop.cuh").write_text(edited_header(parts))
        for lib, *_ in KERNELS.values():
            cu = d / _cuda.SOURCES[lib]
            shutil.copy(_cuda.CSRC_DIR / _cuda.SOURCES[lib], cu)
            path = d / f"{lib}.so"
            procs[variant, lib] = (subprocess.Popen(
                [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(path),
                 str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), path)
    libs = {v: {} for v in VARIANTS}
    for (variant, name), (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            libs[variant][name] = f"nvcc failed: {log[-300:]}"
            continue
        lib = ctypes.CDLL(str(path))
        mod = next(k[1] for k in KERNELS.values() if k[0] == name)
        for fn, argtypes in mod._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[variant][name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_forward_loop_parts: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build_all([k[0] for k in KERNELS.values()])
    built = {lib: _cuda.library(lib, mod._SIGNATURES)
             for lib, mod, *_ in KERNELS.values()}
    libs = build_all()
    data = {(k, t): loop_inputs(spec[-1], t) for k, spec in KERNELS.items()
            for t in STEPS}
    first = lambda out: out[0] if isinstance(out, tuple) else out  # hs
    refs = {k: first(spec[3](*data[k, STEPS[-1]]))
            for k, spec in KERNELS.items()}
    for variant, by_lib in libs.items():
        out = {"variant": variant, "removed": list(VARIANTS[variant])}
        for k, (lib, _, fwd, _, _) in KERNELS.items():
            if isinstance(by_lib[lib], str):
                out[k] = {"error": by_lib[lib]}
                continue
            _cuda._LOADED[lib] = by_lib[lib]
            try:
                ms = [S.time_ms(lambda a=data[k, t]: fwd(*a)) for t in STEPS]
                res = {"ms": dict(zip(STEPS, ms)),
                       "us_per_step": (ms[1] - ms[0])
                       / (STEPS[1] - STEPS[0]) * 1e3}
                if variant == "as_built":
                    got = first(fwd(*data[k, STEPS[-1]]))
                    res["max_abs_err"] = (got - refs[k]).abs().max().item()
                out[k] = res
            finally:
                _cuda._LOADED[lib] = built[lib]
        print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
