"""Ragged paged attention: the page-table walk as one CUDA kernel
(port of `paddle_tpu.ops.ragged_paged_attention`, float arenas).

`q [R, TQ, H, Dh]` with query i of row r at absolute position
`pos0[r] + i`, attending keys `<= pos0[r] + i` of its row's page walk.
Decode rows are TQ=1, prefill chunks TQ=C: one function, one kernel.

- `ragged_reference`: the plain PyTorch version -- gather through the
  page table, then `grouped_masked_attention`; the kernel's target.
- `ragged_kernel`: the wrapper of `csrc/ragged_paged_attention.cu`. It
  takes CUDA tensors only and raises on anything the kernel does not
  take (dtype, head_dim, contiguity, shapes). It counts its launches in
  `launch_counts` ("tq1" for TQ=1 decode reads, "tqn" for TQ>1 chunk
  reads).
- `ragged_attention(..., impl=None|"torch"|"kernel")`: None launches the
  kernel for CUDA tensors and runs the reference for CPU tensors;
  "kernel" on a CPU tensor raises.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.ops.paged_attention import (
    gather_kv,
    grouped_masked_attention,
)

#: launches of the walk kernel, by query width (reset with
#: `reset_launch_counts`)
launch_counts = {"tq1": 0, "tqn": 0}

#: head_dims the kernel is compiled for
KERNEL_HEAD_DIMS = (64, 128)
#: query vectors one block serves (its G heads x its query-row tile)
_QUERIES_PER_BLOCK = 16

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_SIGNATURES = {
    "ragged_walk": [ctypes.c_int, ctypes.c_int,            # dtype, head_dim
                    ctypes.c_void_p, ctypes.c_void_p,      # q, k arena
                    ctypes.c_void_p, ctypes.c_void_p,      # v arena, table
                    ctypes.c_void_p, ctypes.c_void_p,      # pos0, active
                    ctypes.c_void_p,                       # out
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # R, TQ, H
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Hkv, P, page
                    ctypes.c_int, ctypes.c_int,            # max_pages,
                    ctypes.c_void_p],                      # max_len; stream
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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


def _check(q, k_arena, v_arena, page_table, pos0, active, page_size,
           max_len):
    if isinstance(k_arena, tuple) or isinstance(v_arena, tuple):
        raise NotImplementedError(
            "the int8 (s8, scale) walk is not ported yet")
    tensors = dict(q=q, k_arena=k_arena, v_arena=v_arena,
                   page_table=page_table, pos0=pos0, active=active)
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"ragged_kernel: {name} is on {t.device}, "
                             f"the kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"ragged_kernel: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"ragged_kernel: {name} is not contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"ragged_kernel: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    if k_arena.dtype != q.dtype or v_arena.dtype != q.dtype:
        raise ValueError("ragged_kernel: arenas must be in q's dtype "
                         f"({q.dtype}), got {k_arena.dtype}/"
                         f"{v_arena.dtype}")
    if q.ndim != 4 or k_arena.ndim != 4:
        raise ValueError("ragged_kernel: q [R,TQ,H,Dh] and arenas "
                         "[P,page,Hkv,Dh] expected")
    r, tq, h, dh = q.shape
    p, page, hkv, dh_k = k_arena.shape
    if v_arena.shape != k_arena.shape:
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
    if k_arena.data_ptr() % 16 or v_arena.data_ptr() % 16:
        raise ValueError("ragged_kernel: arenas must start on a 16-byte "
                         "boundary (the kernel loads 16-byte vectors)")


def ragged_kernel(q, k_arena, v_arena, page_table, pos0, active, *,
                  page_size: int, max_len: int):
    """Launch the CUDA walk (csrc/ragged_paged_attention.cu) on the
    current stream. CUDA tensors only; raises on anything the kernel
    does not take."""
    _check(q, k_arena, v_arena, page_table, pos0, active, page_size,
           max_len)
    lib = _cuda.library("ragged_paged_attention", _SIGNATURES)
    r, tq, h, dh = q.shape
    p, page, hkv, _ = k_arena.shape
    max_pages = page_table.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ragged_walk(
        _DTYPE_CODE[q.dtype], dh, q.data_ptr(), k_arena.data_ptr(),
        v_arena.data_ptr(), page_table.data_ptr(), pos0.data_ptr(),
        active.data_ptr(), out.data_ptr(), r, tq, h, hkv, p, page,
        max_pages, max_len, stream)
    _cuda.check_launch(err, "ragged_walk")
    launch_counts["tq1" if tq == 1 else "tqn"] += 1
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
