#!/usr/bin/env python3
"""Kernel A (csrc/flash_attention.cu, flash attention forward) on the card
at other tilings, and with parts of its tile loop removed.

    python3 scripts/torch_flash_tiles.py

Builds the source once as it is (the tiling `Tiling` picks per dtype and
head_dim) and once per variant, each from an edited copy of the source
under the build directory (the committed kernel has no switches): other
keys per K/V tile and tiles in the cp.async ring, for every instantiation
at once; then the chosen tiling with parts of the tile loop removed (no
K/V loads after the first tiles, no QK^T, no softmax, no PV: results
wrong, times telling where the time goes). An edit whose anchor is not
found exactly once fails the run. One nvcc per build, all started
together. Times each build at the smoke's shapes (device time with the
L2 flushed, as `chip_smoke.time_ms`), beside SDPA, and holds the full
builds against the plain version (max abs error on the shapes up to
T=2048). Prints one JSON line per build and the card's name and power
limit. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from paddle_tpu_torch.ops import _cuda  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as FA  # noqa: E402

OUT = _cuda.BUILD_DIR / "flash_tiles"
PV = "    fr.pv(acc, s, vs + st * kTile, lane);\n"
# the parts of the tile loop that a variant removes: (anchor, replacement)
# pairs, applied in this order; SOFTMAX cuts from its anchor up to PV's
REMOVE = {
    "LOADS": ("    if (j < j_end) {\n",
              "    if (j < j_end && j < j_beg + kStages - 1) {\n"),
    "SCORES": ("    fr.scores(s, qs, ks + st * kTile, warp, lane);\n", ""),
    "SOFTMAX": ("    // element masks only where the tile crosses", None),
    "PV": (PV, ""),
}


def tiling(keys, stages):
    def edit(src):
        out, n = re.subn(r"kKeys = \d+, kStages = \d+",
                         f"kKeys = {keys}, kStages = {stages}", src)
        if n != 3:
            raise RuntimeError(f"{n} tilings in the source, want 3")
        return out
    return edit


def without(*parts):
    def edit(src):
        for part in REMOVE:
            if part not in parts:
                continue
            anchor, repl = REMOVE[part]
            if src.count(anchor) != 1:
                raise RuntimeError(f"{part}: anchor not found once")
            if repl is None:
                i = src.index(anchor)
                src = src[:i] + src[src.index(PV, i):]
            else:
                src = src.replace(anchor, repl)
        return src
    return edit


# name -> edit of the source
BUILDS = {"chosen": lambda src: src}
for keys, stages in ((32, 2), (32, 3), (32, 4), (32, 6), (64, 2), (64, 3),
                     (64, 4), (128, 2), (128, 3)):
    BUILDS[f"keys{keys}_stages{stages}"] = tiling(keys, stages)
for skip in (("LOADS",), ("SCORES", "PV"), ("SCORES", "SOFTMAX", "PV"),
             ("LOADS", "SCORES", "PV"),
             ("LOADS", "SCORES", "SOFTMAX", "PV")):
    BUILDS["skip_" + "_".join(s.lower() for s in skip)] = without(*skip)

# name, B, T, H, D, dtype: the smoke's shapes (chip_smoke.kernels_phase)
CASES = (("prefill_t128_f32", 1, 128, 8, 64, torch.float32),
         ("t2048_bf16", 1, 2048, 8, 64, torch.bfloat16),
         ("t2048_f32", 1, 2048, 8, 64, torch.float32),
         ("hd128_t256_bf16", 1, 256, 4, 128, torch.bfloat16),
         ("hd128_t256_f32", 1, 256, 4, 128, torch.float32),
         ("t8192_b4_bf16", 4, 8192, 8, 64, torch.bfloat16))


def build_all():
    """{name: loaded library or the compiler's error}"""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC_DIR / _cuda.SOURCES["flash_attention"]).read_text()
    procs = {}
    for name, edit in BUILDS.items():
        cu, path = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(edit(src))
        procs[name] = (subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(path), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            path)
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            libs[name] = f"nvcc failed: {log[-300:]}"
            continue
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in FA._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def causal_fwd(lib, q, k, v, lens):
    """One causal launch of `flash_fwd` from `lib`, as FA.flash_kernel
    launches it: returns o."""
    b, t, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd(
        FA._DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), lens.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h,
        t, t, 1.0 / math.sqrt(d), 1, 0,
        torch.cuda.current_stream().cuda_stream)
    _cuda.check_launch(err, "flash_fwd")
    return o


def inputs(b, t, h, d, dtype):
    rs = np.random.RandomState(0)
    mk = lambda: torch.from_numpy(rs.standard_normal(
        (b, t, h, d)).astype(np.float32)).to("cuda", dtype)
    return mk(), mk(), mk(), torch.full((b,), t, dtype=torch.int32,
                                        device="cuda")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_tiles: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_all()
    sdpa_fn = torch.nn.functional.scaled_dot_product_attention
    data = {c[0]: inputs(*c[1:]) for c in CASES}
    refs = {name: FA.flash_attention_reference(q, k, v, lens, causal=True)[0]
            for name, (q, k, v, lens) in data.items()
            if q.shape[0] * q.shape[1] <= 2048}
    sdpa = {}
    for name, (q, k, v, _) in data.items():
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa[name] = S.time_ms(lambda: sdpa_fn(qh, kh, vh, is_causal=True))
    print(json.dumps({"sdpa_ms": sdpa}), flush=True)
    for build, lib in libs.items():
        out = {"build": build, "ms": {}, "max_abs_err": {}}
        if isinstance(lib, str):
            out["error"] = lib
            print(json.dumps(out), flush=True)
            continue
        for name, (q, k, v, lens) in data.items():
            run = lambda: causal_fwd(lib, q, k, v, lens)
            try:
                o = run()
                torch.cuda.synchronize()
            except RuntimeError as e:   # a tiling that does not fit
                out["ms"][name] = f"refused: {e}"
                continue
            out["ms"][name] = S.time_ms(run)
            if name in refs and not build.startswith("skip"):
                out["max_abs_err"][name] = (
                    o.float() - refs[name].float()).abs().max().item()
        print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
