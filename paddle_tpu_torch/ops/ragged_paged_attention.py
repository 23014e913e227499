"""Ragged paged attention: the page-table walk as one CUDA kernel
(port of `paddle_tpu.ops.ragged_paged_attention`).

`q [R, TQ, H, Dh]` with query i of row r at absolute position
`pos0[r] + i`, attending keys `<= pos0[r] + i` of its row's page walk.
Decode rows are TQ=1, prefill chunks TQ=C, speculative verify windows
TQ=K+1: one function, one kernel.

- `ragged_reference`: the plain PyTorch version -- gather through the
  page table (dequantizing an `(s8, scale)` pair), then
  `grouped_masked_attention`; the kernel's target.
- `ragged_kernel`: the wrapper of `csrc/ragged_paged_attention.cu`'s
  split walk: the walk split over runs of keys across blocks by
  `walk_plan`, the tiles read through the arena's loader (raw float
  tiles for float arenas, kernel B; `(s8 data, f32 scale)` pairs with
  the dequant fused into the reads, kernel C), the splits' partials
  merged in a fixed order by a second launch. It takes CUDA tensors only
  and raises on anything the kernels do not take (dtype, head_dim,
  contiguity, shapes). It counts its calls in `launch_counts`:
  "tq1"/"tqn" for float reads with TQ=1 (decode) and TQ>1 (chunks,
  verify windows), "int8_tq1"/"int8_tqn" for the int8 walk; and the
  device launches (1 or 2 per call) in `device_launches["float"]` (B)
  and `device_launches["int8"]` (C).
- `walk_plan`: the walk's launch plan -- query rows per block, query
  tiles, splits and keys per split -- from the shapes and the SM count.
- `walk_resources`: what each instantiation of the walk takes on the
  card (shared memory, registers, resident blocks per SM, spills).
- `ragged_attention(..., impl=None|"torch"|"kernel")`: None launches the
  kernel for CUDA tensors and runs the reference for CPU tensors;
  "kernel" on a CPU tensor raises.
"""

from __future__ import annotations

import ctypes

import torch

from typing import NamedTuple

from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.ops.paged_attention import (
    gather_kv,
    grouped_masked_attention,
)

#: launches of the walk kernel, by query width (reset with
#: `reset_launch_counts`)
launch_counts = {"tq1": 0, "tqn": 0, "int8_tq1": 0, "int8_tqn": 0}

#: head_dims the kernel is compiled for
KERNEL_HEAD_DIMS = (64, 128)
#: query vectors one block serves (its G heads x its query-row tile)
_QUERIES_PER_BLOCK = 16

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_PLAN = [_I, _I, _I, _I, _I, _I,           # R, TQ, H, Hkv, P, page
         _I, _I,                             # max_pages, max_len
         _I, _I, _I,                         # rows per block, splits, span
         _P, _P]                             # launched, stream
_SIGNATURES = {
    "ragged_walk": [_I, _I,                  # dtype, head_dim
                    _P, _P, _P,              # q, k arena, v arena
                    _P, _P, _P,              # table, pos0, active
                    _P, _P] + _PLAN,         # out, partials
    "ragged_walk_int8": [_I, _I,             # dtype, head_dim
                         _P,                 # q
                         _P, _P, _P, _P,     # k data, scale, v data, scale
                         _P, _P, _P,         # table, pos0, active
                         _P, _P] + _PLAN,    # out, partials
    "walk_resources": [_I, _I, _I, _P],      # int8, dtype, head_dim; out
}


#: device launches of the walk (the split walk, and the combine of its
#: splits where there is more than one): kernel B over float arenas,
#: kernel C over int8 ones
device_launches = {"float": 0, "int8": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, device_launches):
        for k in counts:
            counts[k] = 0


# -- the walk's launch plan ------------------------------------------------

#: keys a tile of the walk holds, and the most keys one block walks (its
#: span's per-key indices, and C's scales, sit in shared memory)
TILE_KEYS = 32
MAX_SPAN_KEYS = 512


class WalkPlan(NamedTuple):
    rows_per_block: int   # query rows a block serves (x G heads <= 16)
    q_tiles: int          # blocks over the TQ query rows
    splits: int           # blocks over the walk's keys, per query tile
    span: int             # keys one split walks

    def blocks(self, rows, kv_heads):
        return rows * kv_heads * self.q_tiles * self.splits


def walk_plan(rows, tq, heads, kv_heads, max_len, page, sms):
    """The walk's grid: a block serves min(TQ, 16 / G) query rows of its
    G = H / Hkv heads; the walk's max_len keys are split into runs of
    `span` keys -- whole pages (whole 32-key tiles where a tile spans
    whole pages), or whole tiles where a page holds more than
    MAX_SPAN_KEYS keys; at most MAX_SPAN_KEYS keys -- so that the grid
    has about 2 * sms blocks or more (fewer only where every split is
    one page, or one tile of a large page, already)."""
    g = heads // kv_heads
    rows_per_block = min(tq, _QUERIES_PER_BLOCK // g)
    q_tiles = -(-tq // rows_per_block)
    unit = page if page <= MAX_SPAN_KEYS else TILE_KEYS
    units = -(-max_len // unit)
    want = -(-2 * sms // (rows * kv_heads * q_tiles))
    tile_units = max(1, TILE_KEYS // unit)
    span = max(1, units // want)
    if span >= tile_units:
        span -= span % tile_units
    span = max(1, min(span, MAX_SPAN_KEYS // unit))
    return WalkPlan(rows_per_block, q_tiles, -(-units // span), span * unit)


_SMS = {}


def _sm_count(device):
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


# -- the plain version ---------------------------------------------------


def ragged_reference(q, k_arena, v_arena, page_table, pos0, active, *,
                     page_size: int, max_len: int):
    """The gather-then-attend path with the per-row causal bound
    `pos0 + i` and the `active` mask."""
    del page_size  # addressing is baked into the table
    k_read = gather_kv(k_arena, page_table, max_len, q.dtype)
    v_read = gather_kv(v_arena, page_table, max_len, q.dtype)
    tq = q.shape[1]
    ap = pos0[:, None].long() + torch.arange(tq, device=q.device)[None, :]
    valid = (torch.arange(max_len, device=q.device)[None, None, :]
             <= ap[:, :, None]) & active[:, None, None]
    return grouped_masked_attention(q, k_read, v_read, valid[:, None])


# -- the kernel ----------------------------------------------------------


def _check_tensors(what, tensors, q):
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"ragged_kernel: {name} is on {t.device}, "
                             f"the kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"ragged_kernel: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"ragged_kernel: {name} is not contiguous")
    for name in what:
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"ragged_kernel: {name} must start on a "
                             f"16-byte boundary (the kernel loads 16-byte "
                             f"vectors)")


def _check(q, k_arena, v_arena, page_table, pos0, active, page_size,
           max_len):
    """Validate a launch; returns the data arena's shape [P, page, Hkv,
    Dh] (of the s8 data for an int8 pair)."""
    quant = isinstance(k_arena, tuple)
    if quant != isinstance(v_arena, tuple):
        raise ValueError("ragged_kernel: K and V arenas must both be "
                         "float or both (s8, scale) pairs")
    tensors = dict(q=q, page_table=page_table, pos0=pos0, active=active)
    if quant:
        if len(k_arena) != 2 or len(v_arena) != 2:
            raise ValueError("ragged_kernel: an int8 arena is an (s8 data,"
                             " f32 scale) pair")
        tensors.update(k_data=k_arena[0], k_scale=k_arena[1],
                       v_data=v_arena[0], v_scale=v_arena[1])
        data = ("k_data", "v_data")
    else:
        tensors.update(k_arena=k_arena, v_arena=v_arena)
        data = ("k_arena", "v_arena")
    _check_tensors(data, tensors, q)
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"ragged_kernel: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    kd, vd = tensors[data[0]], tensors[data[1]]
    if quant:
        if kd.dtype != torch.int8 or vd.dtype != torch.int8:
            raise ValueError("ragged_kernel: int8 arena data must be int8, "
                             f"got {kd.dtype}/{vd.dtype}")
        ks, vs = tensors["k_scale"], tensors["v_scale"]
        if ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise ValueError("ragged_kernel: int8 arena scales must be "
                             f"float32, got {ks.dtype}/{vs.dtype}")
        if ks.shape != kd.shape[:-1] or vs.shape != vd.shape[:-1]:
            raise ValueError("ragged_kernel: scale planes must be [P, page,"
                             f" Hkv] = data.shape[:-1], got "
                             f"{tuple(ks.shape)}/{tuple(vs.shape)} for data "
                             f"{tuple(kd.shape)}")
    elif kd.dtype != q.dtype or vd.dtype != q.dtype:
        raise ValueError("ragged_kernel: arenas must be in q's dtype "
                         f"({q.dtype}), got {kd.dtype}/{vd.dtype}")
    if q.ndim != 4 or kd.ndim != 4:
        raise ValueError("ragged_kernel: q [R,TQ,H,Dh] and arenas "
                         "[P,page,Hkv,Dh] expected")
    r, tq, h, dh = q.shape
    p, page, hkv, dh_k = kd.shape
    if vd.shape != kd.shape:
        raise ValueError("ragged_kernel: K and V arenas differ in shape")
    if dh_k != dh or dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"ragged_kernel: head_dim {dh} (arena {dh_k}) "
                         f"not in {KERNEL_HEAD_DIMS}")
    if page != page_size:
        raise ValueError(f"ragged_kernel: arena page {page} != "
                         f"page_size {page_size}")
    if h % hkv != 0 or h // hkv > _QUERIES_PER_BLOCK:
        raise ValueError(f"ragged_kernel: H={h}, Hkv={hkv}: need Hkv | H "
                         f"and H/Hkv <= {_QUERIES_PER_BLOCK}")
    if page_table.dtype != torch.int32 or pos0.dtype != torch.int32:
        raise ValueError("ragged_kernel: page_table and pos0 must be int32")
    if active.dtype != torch.bool:
        raise ValueError("ragged_kernel: active must be bool")
    if (page_table.ndim != 2 or page_table.shape[0] != r
            or pos0.shape != (r,) or active.shape != (r,)):
        raise ValueError("ragged_kernel: page_table [R, max_pages], pos0 "
                         "[R] and active [R] expected")
    if page_table.shape[1] * page_size < max_len:
        raise ValueError(f"ragged_kernel: the table covers "
                         f"{page_table.shape[1] * page_size} positions < "
                         f"max_len {max_len}")
    if p < 1 or r < 1 or tq < 1 or max_len < 1:
        raise ValueError("ragged_kernel: empty input")
    return p, page, hkv, dh


def ragged_kernel(q, k_arena, v_arena, page_table, pos0, active, *,
                  page_size: int, max_len: int):
    """Launch the CUDA walk (csrc/ragged_paged_attention.cu) on the
    current stream: kernel B for float arenas, kernel C for (s8, scale)
    pairs, both the split walk for `walk_plan`'s grid. CUDA tensors
    only; raises on anything the kernel does not take."""
    p, page, hkv, _ = _check(q, k_arena, v_arena, page_table, pos0, active,
                             page_size, max_len)
    lib = _cuda.library("ragged_paged_attention", _SIGNATURES)
    r, tq, h, dh = q.shape
    out = torch.empty_like(q)
    plan = walk_plan(r, tq, h, hkv, max_len, page, _sm_count(q.device))
    part = torch.empty((plan.splits, r * tq * h, dh + 4) if
                       plan.splits > 1 else (1,), dtype=torch.float32,
                       device=q.device)
    launched = ctypes.c_int(0)
    tail = (page_table.data_ptr(), pos0.data_ptr(), active.data_ptr(),
            out.data_ptr(), part.data_ptr(), r, tq, h, hkv, p, page,
            page_table.shape[1], max_len, plan.rows_per_block, plan.splits,
            plan.span, ctypes.addressof(launched),
            torch.cuda.current_stream(q.device).cuda_stream)
    quant = isinstance(k_arena, tuple)
    if quant:
        fn, kind = "ragged_walk_int8", "int8"
        err = lib.ragged_walk_int8(
            _DTYPE_CODE[q.dtype], dh, q.data_ptr(), k_arena[0].data_ptr(),
            k_arena[1].data_ptr(), v_arena[0].data_ptr(),
            v_arena[1].data_ptr(), *tail)
    else:
        fn, kind = "ragged_walk", "float"
        err = lib.ragged_walk(_DTYPE_CODE[q.dtype], dh, q.data_ptr(),
                              k_arena.data_ptr(), v_arena.data_ptr(), *tail)
    device_launches[kind] += launched.value
    _cuda.check_launch(err, fn)
    launch_counts[("int8_" if quant else "") + ("tq1" if tq == 1
                                                 else "tqn")] += 1
    return out


def walk_resources(device=None):
    """{(arena, dtype, head_dim): (dynamic shared memory bytes, registers
    per thread, blocks resident per SM, spill bytes per thread)} for
    every instantiation of the split walk, arena "float" (B) or "int8"
    (C), read from the card."""
    lib = _cuda.library("ragged_paged_attention", _SIGNATURES)
    out = {}
    with torch.cuda.device(device):
        for kind in ("float", "int8"):
            for dtype, code in _DTYPE_CODE.items():
                for dh in KERNEL_HEAD_DIMS:
                    res = (ctypes.c_int * 4)()
                    err = lib.walk_resources(int(kind == "int8"), code, dh,
                                             ctypes.addressof(res))
                    _cuda.check_launch(err, "walk_resources")
                    out[kind, str(dtype)[6:], dh] = tuple(res)
    return out


def ragged_attention(q, k_arena, v_arena, page_table, pos0, active, *,
                     page_size: int, max_len: int, impl=None):
    """Dispatch: impl in {None, "torch", "kernel"}. None = the kernel
    for CUDA tensors, the reference for CPU tensors."""
    if impl not in (None, "torch", "kernel"):
        raise ValueError(f"impl must be None|torch|kernel, got {impl!r}")
    if impl == "kernel" or (impl is None and q.is_cuda):
        return ragged_kernel(q, k_arena, v_arena, page_table, pos0,
                             active, page_size=page_size, max_len=max_len)
    return ragged_reference(q, k_arena, v_arena, page_table, pos0, active,
                            page_size=page_size, max_len=max_len)
