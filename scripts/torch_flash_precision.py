#!/usr/bin/env python3
"""Where kernel A's f32 error comes from on long causal rows.

    python3 scripts/torch_flash_precision.py [--long T]

Kernel A (csrc/flash_attention.cu) in f32 at bench_transformer_lm's
attention (causal T=8192, B=4, H=8, D=64, the inputs of chip_smoke.py's
`causal_t8192_b4` case, seed 0), full causal and with a window of 1024,
held against a float64 plain version. Beside it, on the same inputs and
against the same float64 output: the f32 plain version (TF32 off, as the
smoke runs it), the plain version with TF32 on (one TF32 pass, the
control for the kernel's 3xTF32 split), and the kernel's online softmax
written out in PyTorch in f32 (32-key tiles, IEEE adds). Builds the
committed source and edited copies of it under the build directory (the
committed kernel has no switches; an edit whose anchor is not found once
fails the run), one nvcc per build, all started together. The committed
kernel accumulates each 32-key tile's P V products on the tensor cores
from zero, in two passes over the head dim, and adds the tile's sums to
the running output with f32 adds; the copies:

  one_pass     the same in one pass (all of the tile's sums live);
  deferred     one pass, the add made at the next tile's rescale;
  running_acc  the P V products accumulate on the tensor cores straight
               into the running output (the design before).

For each output: the max abs error, the row-relative error (each
(b, t, h) row's max abs error over that row's max |reference|, as
chip_smoke.py's `row_rel_err`), the same per quarter of the query
positions, and the share of nonzero errors that shrink the output toward
zero (0.5 for unbiased rounding; a tensor core that truncates its f32
accumulator shrinks sums). Each build's time at chip_smoke.py's causal
f32 shapes (device time with the L2 flushed, as `chip_smoke.time_ms`;
the builds in turn, committed first and last, twice), its registers and
spills per instantiation (ptxas), and the SASS instructions of its f32
D=64 kernel by opcode (`cuobjdump --dump-sass`). Prints one JSON line
per case, one for the times and one per build's resources, then the
card's name and power limit. Needs a CUDA device; exits 2 without one.

--long T: only the committed kernel (as the package builds it), causal
f32 at B=1 and T keys, H=8, D=64 (seed 0), against the float64 plain
version and the f32 plain version one head at a time (a head's float64
scores take 8 T^2 bytes), on the same measures; one JSON line and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
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

OUT = _cuda.BUILD_DIR / "flash_precision"
B, T, H, D = 4, 8192, 8, 64
KEYS = 32   # Tiling<float, D>::kKeys
# name, B, T, H, D: chip_smoke.py's causal f32 shapes of A
SHAPES = (("prefill_t128", 1, 128, 8, 64), ("t2048", 1, 2048, 8, 64),
          ("hd128_t256", 1, 256, 4, 128), ("t8192_b4", B, T, H, D))
KDG = "    constexpr int kDG = D / 16;          // column blocks a pass\n"
TWO_PASS = KDG + """#pragma unroll
    for (int d0 = 0; d0 < D / 8; d0 += kDG) {
      float t[kDG][4] = {};
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const float x[4] = {s[nb][0], s[nb][2], s[nb][1], s[nb][3]};
        unsigned ah[4], al[4];
        split_tf32(x, ah, al);
#pragma unroll
        for (int dn = 0; dn < kDG; ++dn) {
          const float b[2] = {p[nb * 8 * kLd + (d0 + dn) * 8],
                              p[(nb * 8 + 1) * kLd + (d0 + dn) * 8]};
          unsigned bh[2], bl[2];
          split_tf32(b, bh, bl);
          mma_3xtf32(t[dn], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int dn = 0; dn < kDG; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d0 + dn][e] += t[dn][e];
    }
"""


def one_pass(into):
    """P V in one pass over the head dim, accumulated on the tensor cores
    into `into` (acc: O itself; t: a tile's sums)."""
    return """#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const float x[4] = {s[nb][0], s[nb][2], s[nb][1], s[nb][3]};
      unsigned ah[4], al[4];
      split_tf32(x, ah, al);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const float b[2] = {p[nb * 8 * kLd + dn * 8],
                            p[(nb * 8 + 1) * kLd + dn * 8]};
        unsigned bh[2], bl[2];
        split_tf32(b, bh, bl);
        mma_3xtf32(%s[dn], ah, al, bh, bl);
      }
    }
""" % into


# the deferred add: a tile's sums kept in the fragment object and added
# to O at the next tile's rescale (and once after the last tile)
FOLD = """  float t[D / 8][4] = {};

  __device__ __forceinline__ void fold(float (&acc)[D / 8][4]) {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[dn][e] += t[dn][e];
        t[dn][e] = 0.f;
      }
  }

"""
PV_F32 = "  // acc += P V, 3xTF32."
PV_CONST = """                                     int lane) const {
    const int g = lane >> 2, c = lane & 3;
    const T* p = vt + 2 * c * kLd + g;  // B(key 2c, dim g)
"""
PV_BF16 = "  // acc += round_bf16(P) V\n"
RESCALE = "    float base[2];  // m * scale * log2(e)"
LAST_PV = "    fr.pv(acc, s, vs + st * kTile, lane);\n  }\n"


def _edit(src, pairs):
    for anchor, repl in pairs:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, repl)
    return src


BUILDS = {
    "committed": lambda src: src,
    # one pass over the head dim, all of the tile's sums live at once
    "one_pass": lambda src: _edit(src, [
        (KDG, KDG.replace("D / 16", "D / 8"))]),
    "deferred": lambda src: _edit(src, [
        (PV_BF16, "  __device__ __forceinline__ void fold(float (&)[D / 8]"
                  "[4]) {}\n\n" + PV_BF16),
        (PV_F32, FOLD + PV_F32),
        (PV_CONST, PV_CONST.replace(" const {", " {")),
        (TWO_PASS, one_pass("t")),
        (RESCALE, "    fr.fold(acc);\n" + RESCALE),
        (LAST_PV, LAST_PV + "  fr.fold(acc);\n")]),
    # the design before: P V straight into O on the tensor cores
    "running_acc": lambda src: _edit(src, [(TWO_PASS, one_pass("acc"))]),
}


def build_all():
    """({name: loaded library or the compiler's error}, {name: resources})
    where resources are each instantiation's registers and spill bytes
    (ptxas) and the f32 D=64 kernel's SASS instructions by opcode."""
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
    libs, res = {}, {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            libs[name] = f"nvcc failed: {log[-300:]}"
            continue
        res[name] = resources(log, path)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in FA._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, res


def resources(log, path):
    """Registers and spill stores per flash_fwd_kernel instantiation
    from ptxas's log, and the f32 D=64 kernel's SASS opcodes."""
    regs, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", line)
        if "Compiling entry" in line:
            cur = None if m is None else (
                f"{'float32' if m.group(1) == 'f' else 'bfloat16'}, "
                f"D={m.group(2)}")
        elif cur is not None and "spill stores" in line:
            regs.setdefault(cur, {})["spill_stores"] = int(
                re.search(r"(\d+) bytes spill stores", line).group(1))
        elif cur is not None and "Used" in line:
            regs.setdefault(cur, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    cuobjdump = os.path.join(os.path.dirname(_cuda.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ops, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "flash_fwd_kernelIfLi64E" in line
        elif inside:
            m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]"
                         r"[A-Z0-9_]*)", line)
            if m:
                ops[m.group(1).split(".")[0]] += 1
    return dict(instantiations=regs, sass_f32_d64=dict(
        total=sum(ops.values()), **dict(ops.most_common(12))))


def kernel_fwd(lib, q, k, v, lens, window):
    """One causal launch of `flash_fwd` from `lib`, as FA.flash_kernel
    launches it: returns o."""
    b, t, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd(
        FA._DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), lens.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h,
        t, t, 1.0 / math.sqrt(d), 1, window or 0,
        torch.cuda.current_stream().cuda_stream)
    _cuda.check_launch(err, "flash_fwd")
    return o


def plain_f64(q, k, v, lens, window):
    """The plain version's formula in float64 (q, k, v one batch row)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qd, kd, vd = (x.double().permute(0, 2, 1, 3) for x in (q, k, v))
    s = torch.matmul(qd, kd.transpose(-1, -2)) * scale
    valid = FA._valid_mask(q.shape[1], k.shape[1], lens, True, window,
                           q.device)
    s.masked_fill_(~valid, -math.inf)
    s -= s.amax(dim=-1, keepdim=True)
    s.exp_()
    o = torch.matmul(s, vd) / s.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3)


def online_f32(q, k, v, window):
    """The kernel's online softmax in PyTorch, f32 with IEEE adds: KEYS
    keys a tile, running max, sum and output (q, k, v one batch row)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (x.float().permute(0, 2, 1, 3)[0] for x in (q, k, v))
    t = qf.shape[1]
    qpos = torch.arange(t, device=q.device)[:, None]
    m = torch.full((qf.shape[0], t, 1), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, t, KEYS):
        k1 = min(k0 + KEYS, t)
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        ok = qpos >= kpos
        if window is not None:
            ok = ok & (qpos - kpos < window)
        s = torch.matmul(qf, kf[:, k0:k1].transpose(-1, -2)) * scale
        s = s.masked_fill(~ok, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new).masked_fill(~ok, 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vf[:, k0:k1])
        m = m_new
    return (acc / l).permute(1, 0, 2)[None]


class Stats:
    """Max abs error, row-relative error (overall and per quarter of the
    query positions) and the share of errors toward zero, over rows."""

    def __init__(self):
        self.abs = self.row = 0.0
        self.quarters = [0.0] * 4
        self.toward = self.nonzero = 0

    def add(self, got, ref):
        ref = ref.double()
        diff = got.double() - ref
        self.abs = max(self.abs, diff.abs().max().item())
        row = diff.abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)
        self.row = max(self.row, row.max().item())
        for i, part in enumerate(row.chunk(4, dim=1)):
            self.quarters[i] = max(self.quarters[i], part.max().item())
        nz = diff != 0
        self.nonzero += int(nz.sum())
        self.toward += int((nz & (diff * ref < 0)).sum())

    def out(self):
        return dict(max_abs_err=self.abs, row_rel_err=self.row,
                    row_rel_err_by_quarter=self.quarters,
                    toward_zero_share=self.toward / max(self.nonzero, 1))


def case(libs, window):
    rs = np.random.RandomState(0)
    mk = lambda: torch.from_numpy(rs.standard_normal(
        (B, T, H, D)).astype(np.float32)).cuda()
    q, k, v = mk(), mk(), mk()
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    outs = {name: kernel_fwd(lib, q, k, v, lens, window)
            for name, lib in libs.items()}
    vs64 = {name: Stats() for name in
            [*outs, "plain_f32", "plain_tf32", "online_f32"]}
    vs32 = {name: Stats() for name in outs}
    for i in range(B):
        r = slice(i, i + 1)
        ref = plain_f64(q[r], k[r], v[r], lens[r], window)
        torch.backends.cuda.matmul.allow_tf32 = False
        p32 = FA.flash_attention_reference(q[r], k[r], v[r], lens[r],
                                           causal=True, window=window)[0]
        torch.backends.cuda.matmul.allow_tf32 = True
        ptf = FA.flash_attention_reference(q[r], k[r], v[r], lens[r],
                                           causal=True, window=window)[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        vs64["plain_f32"].add(p32, ref)
        vs64["plain_tf32"].add(ptf, ref)
        vs64["online_f32"].add(online_f32(q[r], k[r], v[r], window), ref)
        for name, o in outs.items():
            vs64[name].add(o[r], ref)
            vs32[name].add(o[r], p32)
        del ref, p32, ptf
        torch.cuda.empty_cache()
    return dict(case=f"causal_t{T}_b{B}" + (f"_window{window}" if window
                                             else ""),
                vs_float64={n: s.out() for n, s in vs64.items()},
                kernel_vs_plain_f32={n: s.out() for n, s in vs32.items()})


def long_case(t):
    """The committed kernel at causal B=1, T=t, f32, held one head at a
    time against the float64 and the f32 plain versions."""
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.standard_normal((1, t, H, D)).astype(
        np.float32)).cuda() for _ in range(3))
    lens = torch.full((1,), t, dtype=torch.int32, device="cuda")
    o = FA.flash_kernel(q, k, v, lens, causal=True)[0]
    vs64, vs32, p32_vs64 = Stats(), Stats(), Stats()
    for h in range(H):
        r = slice(h, h + 1)
        qh, kh, vh = (x[:, :, r].contiguous() for x in (q, k, v))
        ref = plain_f64(qh, kh, vh, lens, None)
        p32 = FA.flash_attention_reference(qh, kh, vh, lens,
                                           causal=True)[0]
        vs64.add(o[:, :, r], ref)
        vs32.add(o[:, :, r], p32)
        p32_vs64.add(p32, ref)
        del ref, p32
        torch.cuda.empty_cache()
    return dict(case=f"causal_t{t}_b1_f32", kernel_vs_float64=vs64.out(),
                kernel_vs_plain_f32=vs32.out(),
                plain_f32_vs_float64=p32_vs64.out())


def card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--long", type=int, default=None, metavar="T")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_precision: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.long:
        print(json.dumps(long_case(args.long)), flush=True)
        print(card(), flush=True)
        return 0
    built, res = build_all()
    libs = {n: lib for n, lib in built.items() if not isinstance(lib, str)}
    for n, r in res.items():
        print(json.dumps({"build": n, **r}), flush=True)
    for n, lib in built.items():
        if isinstance(lib, str):
            print(json.dumps({"build": n, "error": lib}), flush=True)
    for window in (None, 1024):
        print(json.dumps(case(libs, window)), flush=True)
    times = {}
    for shape, b, t, h, d in SHAPES:
        rs = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(rs.standard_normal((b, t, h, d)).astype(
            np.float32)).cuda() for _ in range(3))
        lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
        ms = times[shape] = {}
        for _ in range(2):   # builds in turn: committed first and last
            for n, lib in [*libs.items(), *reversed(libs.items())]:
                ms.setdefault(n, []).append(S.time_ms(
                    lambda: kernel_fwd(lib, q, k, v, lens, None)))
    print(json.dumps({"ms_causal_f32": times}), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
