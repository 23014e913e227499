"""Host plumbing shared by the time-loop kernels (`csrc/time_loop.cuh`,
used by `csrc/fused_lstm.cu`, `csrc/fused_gru.cu` and
`csrc/fused_rnn.cu`): input checks, the launch geometry, the card's
limits and launch errors.

Serial-loop geometry of E, G, I (`backward_geometry`) and D, F, H
(`forward_geometry`): the loop's grid is row groups x unit groups; a CTA
owns br rows and hb units in thread tiles of ROW_TILE * rep rows x
unit_tile units (`LOOP_TILES`, `forward_tiles(gates)`), `rep` (row,
unit) pairs per thread, keeps its units' weight rows resident (the
backward's rows of w_hh, [hb][gates*H + 4] f32; the forward's gate
columns of w_hh as rows, [gates][hb][H + 4] f32) where they fit (else
the loop reads them from global memory, through L2) and stages its rows
of the exchanged operand in two chunks of `chunk` columns. The parallel phases are tiled
products of GEMM_TILE x GEMM_TILE outputs; dW_hh's is split over the T*B
rows (`dw_splits`) to fill the card.

A shape the kernels do not take raises ValueError naming the limit;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from paddle_tpu_torch.ops import _cuda

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


#: the backward loop's thread tiles, (unit_tile, rep, launch bound): a
#: tile of ROW_TILE * rep rows x unit_tile units, 4 * unit_tile lanes each
#: carrying rep pairs; more pairs per thread at a lower bound, so that
#: the registers hold them. Then the operand chunk widths (a staged row
#: is padded by 16 bytes) and the tiled products' tile.
LOOP_TILES = ((4, 1, 768), (2, 1, 768), (2, 2, 512), (2, 4, 512))
#: the forward loop's thread tiles: the same shapes, each lane keeping
#: `gates` sums per pair, and 32 rows x 1 unit, 8 pairs a thread, for
#: the largest batches; (unit_tile, rep, launch bound with one gate
#: column (H), with up to 3 (F), with 4 (D)), as `time_loop.cuh
#: forward_bound` declares them
FORWARD_TILES = ((4, 1, 768, 384, 256), (2, 1, 640, 512, 384),
                 (2, 2, 384, 384, 256), (2, 4, 512, 256, 256),
                 (1, 8, 512, 256, 256))
ROW_TILE = 4
CHUNK_WIDTHS = (512, 256, 128, 64, 32)
GEMM_TILE = 128


class LoopGeometry(NamedTuple):
    row_groups: int
    unit_groups: int
    hb: int           # hidden units per CTA
    br: int           # batch rows per CTA
    unit_tile: int    # units per thread tile
    threads: int
    chunk: int        # operand columns per staged chunk
    smem: int         # dynamic shared memory bytes
    rep: int          # pairs per thread (thread tiles of 4 * rep rows)
    resident: bool    # the weight rows held in shared memory

    @property
    def ctas(self):
        return self.row_groups * self.unit_groups



# a search over ~10^4 candidate grids (~1 ms of host time), asked at every
# call of a time-loop kernel: remembered per shape
@functools.lru_cache(maxsize=256)
def _loop_grid(what, batch, hidden, sms, smem_optin, tiles, cols, per_unit):
    """The serial loop's grid: a unit holds `per_unit` weight rows of
    `cols` columns (the product's depth). Among the grids whose staged
    chunks (and resident rows) fit `smem_optin` and whose thread tiles fit
    their launch bound: the weight rows resident if any grid holds them,
    then the most CTAs (<= sms, so the grid can be co-resident), then the
    fewest rows read from L2 each step (operand rows, and the weight rows
    once per row group when they are not resident), then the fewest
    pairs per thread, the widest chunk and the larger unit tile."""
    if hidden % 4:
        raise ValueError(f"{what}: hidden {hidden} must be a multiple of 4 "
                         f"(16-byte tile rows)")
    best = None
    for ut, rep, bound in tiles:
        rows_tile = ROW_TILE * rep
        for hb in range(ut, hidden + 1, ut):
            units = hidden // hb
            if hidden % hb or units > sms:
                continue
            for resident in (True, False):
                held = per_unit * hb * (cols + 4) * 4 if resident else 0
                for rows in range(1, sms // units + 1):
                    br = -(-(-(-batch // rows)) // rows_tile) * rows_tile
                    if -(-batch // br) != rows:     # no empty row group
                        continue
                    threads = -(-br * hb // rep // 32) * 32
                    fit = [w for w in CHUNK_WIDTHS
                           if held + 2 * br * (w + 4) * 4 <= smem_optin]
                    if threads > bound or not fit:
                        continue
                    width = min(fit[0], -(-cols // 8) * 8)
                    cand = LoopGeometry(
                        rows, units, hb, br, ut, threads, width,
                        held + 2 * br * (width + 4) * 4, rep, resident)
                    # rows of operand (and of weights, when not resident)
                    # that the CTAs read from L2 each step
                    trips = cand.ctas * br + (0 if resident else
                                              rows * hidden * per_unit)
                    key = (not resident, -cand.ctas, trips, rep, -width,
                           -ut)
                    if best is None or key < best[0]:
                        best = (key, cand)
    if best is None:
        most = max(bound * rep for _, rep, bound in tiles)
        raise ValueError(
            f"{what}: B={batch}, H={hidden}: no grid of row groups x unit "
            f"groups fits -- at most {sms} CTAs (one per SM), {most} "
            f"(row, unit) pairs per CTA, and two staged operand chunks "
            f"within the card's {smem_optin} bytes of shared memory per "
            f"block")
    return best[1]


def backward_geometry(what, batch, hidden, gates, sms, smem_optin):
    """The backward serial loop's grid (E, G, I): the carry's product
    dgates @ w_hh^T, a unit's row of w_hh ([gates*H] columns) resident
    as [hb][gates*H + 4] f32 where it fits."""
    return _loop_grid(what, batch, hidden, sms, smem_optin, LOOP_TILES,
                      gates * hidden, 1)


def forward_tiles(gates):
    """The forward loop's (unit_tile, rep, launch bound) for a cell of
    `gates` gate columns per unit."""
    col = 2 if gates == 1 else 3 if gates <= 3 else 4
    return tuple((tile[0], tile[1], tile[col]) for tile in FORWARD_TILES)


def forward_geometry(what, batch, hidden, gates, sms, smem_optin):
    """The forward serial loop's grid (D, F, H): the product round_w(h) @
    w_hh, a unit's `gates` columns of w_hh resident as rows [gates][hb]
    [H + 4] f32 where they fit (else read from w_hh^T through L2), the
    thread tiles of `forward_tiles(gates)`."""
    return _loop_grid(what, batch, hidden, sms, smem_optin,
                      forward_tiles(gates), hidden, gates)


def dw_splits(rows, hidden, gates, sms):
    """(splits, rows per split) of dW_hh's product over the T*B rows:
    about two CTAs per SM over the [H, gates*H] output tiles, at most 16
    parts, each a multiple of 8 rows."""
    tiles = -(-hidden // GEMM_TILE) * -(-gates * hidden // GEMM_TILE)
    splits = max(1, min(16, round(2 * sms / tiles)))
    chunk = -(-(-(-rows // splits)) // 8) * 8
    return -(-rows // chunk), chunk


def operand_ld(cols):
    """Row stride of the exchanged operand: columns rounded up to 8, so a
    row of bf16 starts on 16 bytes."""
    return -(-cols // 8) * 8


def record(events, i):
    """Record events[i] on the current stream, if events were given."""
    if events is not None:
        events[i].record()


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
