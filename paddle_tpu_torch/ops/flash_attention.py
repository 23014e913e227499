"""Flash attention, forward (port of `paddle_tpu.ops.flash_attention`).

- `flash_attention_reference`: the plain PyTorch version of what the
  kernel computes -- f32 scores, the per-row `key_lens` bound, causal
  and sliding-`window` masks, p zeroed where a key is invalid (a row
  with no valid key returns 0), and the row log-sum-exp.
- `flash_kernel`: the wrapper of `csrc/flash_attention.cu` (tensor-core
  products: bf16 `mma.sync`, f32 as 3xTF32). CUDA tensors only; it
  raises on anything the kernel does not take (dtype, head_dim,
  contiguity, alignment, shapes) and counts its launches in
  `launch_counts`.
- `flash_attention(q, k, v, *, causal, key_lens, window)`: the public
  function with the JAX checks. The kernel for CUDA tensors, the plain
  version for CPU tensors.

Forward only: the wrapper raises when an input requires grad (the
autograd Function and the backward come with the training path).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from paddle_tpu_torch.ops import _cuda

NEG_INF = -1e30

#: launches of the flash forward kernel (reset with reset_launch_counts)
launch_counts = {"fwd": 0}

#: head_dims the kernel is compiled for
KERNEL_HEAD_DIMS = (64, 128)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_SIGNATURES = {
    "flash_fwd": [ctypes.c_int, ctypes.c_int,              # dtype, head_dim
                  ctypes.c_void_p, ctypes.c_void_p,        # q, k
                  ctypes.c_void_p, ctypes.c_void_p,        # v, lens
                  ctypes.c_void_p, ctypes.c_void_p,        # o, lse
                  ctypes.c_int, ctypes.c_int,              # B, H
                  ctypes.c_int, ctypes.c_int,              # Tq, Tk
                  ctypes.c_float, ctypes.c_int,            # scale, causal
                  ctypes.c_int, ctypes.c_void_p],          # window, stream
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _valid_mask(tq, tk, lens, causal, window, device):
    """[B, 1, Tq, Tk] bool: key < lens[b] (and causal/window)."""
    kpos = torch.arange(tk, device=device)
    valid = (kpos[None, :] < lens.long()[:, None])[:, None, None, :]
    if causal:
        qpos = torch.arange(tq, device=device)[:, None]
        band = qpos >= kpos[None, :]
        if window is not None:
            band = band & (qpos - kpos[None, :] < window)
        valid = valid & band[None, None]
    return valid


def flash_attention_reference(q, k, v, lens, *, causal: bool,
                              window: Optional[int] = None):
    """The kernel's function in plain PyTorch. q [B, Tq, H, D]; k, v
    [B, Tk, H, D]; lens [B] valid key counts (<= Tk). Returns (o [B, Tq,
    H, D] in q's dtype, lse [B, H, Tq] f32)."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    qf = q.float().permute(0, 2, 1, 3)                      # [B, H, Tq, D]
    kf = k.float().permute(0, 2, 1, 3)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale      # [B, H, Tq, Tk]
    valid = _valid_mask(q.shape[1], k.shape[1], lens, causal, window,
                        q.device)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    # the PV operand in v's dtype, as the kernel (and the TPU kernel) use it
    pv = p.to(v.dtype).float()
    o = torch.matmul(pv, v.float().permute(0, 2, 1, 3)) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return o.permute(0, 2, 1, 3).to(q.dtype), lse


def _check(q, k, v, lens, window):
    for name, t in dict(q=q, k=k, v=v, lens=lens).items():
        if not t.is_cuda:
            raise ValueError(f"flash_kernel: {name} is on {t.device}, the "
                             f"kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"flash_kernel: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_kernel: {name} is not contiguous")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_kernel: q/k/v must share one dtype of "
                         f"float32/bfloat16, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("flash_kernel: q [B,Tq,H,D], k/v [B,Tk,H,D] "
                         "expected")
    b, tq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"flash_kernel: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_kernel: head_dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if lens.dtype != torch.int32 or lens.shape != (b,):
        raise ValueError("flash_kernel: lens must be int32 [B]")
    if window is not None and window < 1:
        raise ValueError(f"flash_kernel: window must be >= 1, got {window}")
    if tq < 1 or k.shape[1] < 1:
        raise ValueError("flash_kernel: empty sequence")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_kernel: q, k and v must start on a 16-byte "
                         "boundary (the kernel copies 16-byte vectors)")


def flash_kernel(q, k, v, lens, *, causal: bool,
                 window: Optional[int] = None):
    """Launch the CUDA forward (csrc/flash_attention.cu) on the current
    stream. Same contract as flash_attention_reference."""
    _check(q, k, v, lens, window)
    lib = _cuda.library("flash_attention", _SIGNATURES)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lens.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, tq, tk,
        1.0 / math.sqrt(d), int(causal), 0 if window is None else window,
        stream)
    _cuda.check_launch(err, "flash_fwd")
    launch_counts["fwd"] += 1
    return o, lse


def flash_attention(q, k, v, *, causal: bool = False, key_lens=None,
                    window: Optional[int] = None):
    """Fused scaled-dot-product attention, forward.

    q: [B, Tq, H, D]; k, v: [B, Tkv, H, D]. Returns [B, Tq, H, D].
    key_lens: optional [B] int -- row b
    attends only keys [0, lens[b]). window: sliding-window attention
    (query t attends keys (t-window, t]); requires causal=True. Causal
    attention requires Tq == Tkv."""
    if q.ndim != 4:
        raise ValueError(f"expected [B, T, H, D], got {tuple(q.shape)}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in this port: the autograd "
            "Function and its backward come with the training path")
    b, t, h, d = q.shape
    t_kv = k.shape[1]
    if causal and t != t_kv:
        raise ValueError(
            f"causal flash attention requires Tq == Tkv, got {t} vs "
            f"{t_kv}; use the dense path for offset cross-attention")
    if key_lens is None:
        lens = torch.full((b,), t_kv, dtype=torch.int32, device=q.device)
    else:
        if tuple(key_lens.shape) != (b,):
            raise ValueError(
                f"key_lens must be [B]=({b},), got {tuple(key_lens.shape)}")
        # clamp so out-of-range lengths degrade to the no-mask behavior
        lens = torch.clamp(key_lens.to(device=q.device, dtype=torch.int32),
                           max=t_kv)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    impl = flash_kernel if q.is_cuda else flash_attention_reference
    return impl(q, k, v, lens, causal=causal, window=window)[0]
