"""Host plumbing shared by the GRU and tanh-RNN time-loop kernels
(`csrc/time_loop.cuh`, used by `csrc/fused_gru.cu` and
`csrc/fused_rnn.cu`): input checks, the launch geometry, the card's
limits and launch errors.

Geometry: CTA k owns hb hidden units (hb the smallest divisor of H with
H / hb <= the SM count, so the grid is at most one CTA per SM and can be
co-resident), a thread carries up to MAX_PAIRS (row, unit) pairs, and
every CTA keeps its units' slices of w_hh resident in shared memory
beside one staged tile of B rows, as wide as the room left allows. A
shape the kernels do not take raises ValueError naming the limit; there
is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops import _cuda

#: threads per CTA, (row, unit) pairs per thread, and the widths a staged
#: tile may take (a row is padded by 4 floats)
MAX_THREADS = 512
MAX_PAIRS = 4
TILE_WIDTHS = (512, 256, 128, 64)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_COOP_TOO_LARGE = 720   # cudaErrorCooperativeLaunchTooLarge


def live(bounds, t):
    """[B, 1] bool: is step t inside each row's [start, end) window."""
    return (bounds[:, :1] <= t) & (t < bounds[:, 1:2])


def operand(x, w_dtype):
    """x rounded to the weight's dtype, then f32: the TPU kernel's
    `x.astype(w_hh.dtype)` fed to an f32-accumulating product."""
    return x.to(w_dtype).float()


def check_inputs(what, x_proj, w_hh, h0, bounds, gates):
    """Shapes and dtypes first (so a refused shape raises on any device),
    then that every tensor lies on one CUDA device. Returns (T, B, H)."""
    if x_proj.dtype not in DTYPE_CODE or w_hh.dtype not in DTYPE_CODE:
        raise ValueError(f"{what}: x_proj and w_hh must be float32 or "
                         f"bfloat16, got {x_proj.dtype}/{w_hh.dtype}")
    if x_proj.ndim != 3 or x_proj.shape[2] % gates:
        raise ValueError(f"{what}: x_proj [T, B, {gates}H] expected, got "
                         f"{tuple(x_proj.shape)}")
    steps, b, g = x_proj.shape
    hidden = g // gates
    if steps < 1 or b < 1 or hidden < 1:
        raise ValueError(f"{what}: empty sequence, batch or width")
    if hidden % 4:
        raise ValueError(f"{what}: hidden {hidden} must be a multiple of 4 "
                         f"(16-byte tile rows)")
    if tuple(w_hh.shape) != (hidden, g):
        raise ValueError(f"{what}: w_hh {tuple(w_hh.shape)} does not match "
                         f"x_proj {tuple(x_proj.shape)}")
    if tuple(h0.shape) != (b, hidden):
        raise ValueError(f"{what}: h0 must be [B, H] = ({b}, {hidden}), got "
                         f"{tuple(h0.shape)}")
    if bounds.dtype != torch.int32 or tuple(bounds.shape) != (b, 2):
        raise ValueError(f"{what}: bounds must be int32 [B, 2]")
    for name, t in dict(x_proj=x_proj, w_hh=w_hh, h0=h0,
                        bounds=bounds).items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, the kernel "
                             f"takes CUDA tensors only")
        if t.device != x_proj.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x_proj on "
                             f"{x_proj.device}")
    return steps, b, hidden


def units_and_threads(what, batch, hidden, sms):
    """(hb, threads): the fewest hidden units per CTA with at most one CTA
    per SM, and the (B x hb) pairs over at most MAX_THREADS threads."""
    hb = next(d for d in range(1, hidden + 1)
              if hidden % d == 0 and hidden // d <= sms)
    pairs = batch * hb
    if pairs > MAX_THREADS * MAX_PAIRS:
        raise ValueError(
            f"{what}: B={batch} x {hb} units per CTA = {pairs} (row, unit) "
            f"pairs exceeds {MAX_THREADS * MAX_PAIRS} ({MAX_THREADS} threads "
            f"x {MAX_PAIRS} pairs)")
    per_thread = -(-pairs // MAX_THREADS)
    threads = -(-pairs // per_thread)
    return hb, -(-threads // 32) * 32


def pick_tile(what, batch, hidden, resident, smem_optin):
    """(tile width, shared-memory bytes): the widest tile (no wider than
    H) that fits beside `resident` bytes; raises when even the narrowest
    does not."""
    tile = lambda width: batch * (width + 4) * 4
    widths = sorted({min(w, hidden) for w in TILE_WIDTHS}, reverse=True)
    if resident + tile(widths[-1]) > smem_optin:
        raise ValueError(
            f"{what}: B={batch}, H={hidden} needs {resident} bytes of "
            f"resident slices and {tile(widths[-1])} for a tile of "
            f"{widths[-1]} columns; the card allows {smem_optin} bytes of "
            f"shared memory per block")
    width = next(w for w in widths if resident + tile(w) <= smem_optin)
    return width, resident + tile(width)


_LIMITS = {}


def device_limits(lib_name, signatures, fn, device):
    """(SM count, opt-in shared memory per block) of the card, read once
    per device through the library's `fn`; raises if it has no
    cooperative launches."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _LIMITS:
        lib = _cuda.library(lib_name, signatures)
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(idx):
            err = getattr(lib, fn)(ctypes.addressof(out))
        _cuda.check_launch(err, fn)
        if not out[2]:
            raise RuntimeError(f"{lib_name}: the card does not support "
                               f"cooperative launches")
        _LIMITS[idx] = (out[0], out[1])
    return _LIMITS[idx]


def launch_error(err, what):
    if err == _COOP_TOO_LARGE:
        raise RuntimeError(f"{what}: the grid cannot be co-resident on this "
                           f"card (cudaErrorCooperativeLaunchTooLarge)")
    _cuda.check_launch(err, what)
