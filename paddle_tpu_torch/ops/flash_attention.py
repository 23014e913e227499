"""Flash attention (port of `paddle_tpu.ops.flash_attention`).

- `flash_attention_reference`: the plain PyTorch version of what the
  kernel computes -- f32 scores, the per-row `key_lens` bound, causal
  and sliding-`window` masks, p zeroed where a key is invalid (a row
  with no valid key returns 0), and the row log-sum-exp.
- `flash_kernel`: the wrapper of `csrc/flash_attention.cu` (tensor-core
  products: bf16 `mma.sync`, f32 as 3xTF32). CUDA tensors only; it
  raises on anything the kernel does not take (dtype, head_dim,
  contiguity, alignment, shapes) and counts its launches in
  `launch_counts`.
- `flash_backward`: the backward, recomputed block by block over keys
  in plain PyTorch (f32 products through `torch.matmul`), a line-for-line
  port of the JAX package's `_blockwise_backward` and, under a sliding
  window, `_windowed_backward` (which gathers only the queries a key
  block can reach). The JAX package's backward is plain JAX too.
- `flash_fwd`: the registered operator `paddle_tpu_torch::flash_fwd(q,
  k, v, lens, causal, window, block_k) -> (o, lse)`
  (`torch.library.custom_op`): its CUDA implementation is
  `flash_kernel`, its CPU one `flash_attention_reference`, its fake one
  the shapes of o and lse, and its autograd formula `flash_backward`
  (the counterpart of JAX's custom_vjp; block_k is the backward's key
  block, lse takes no gradient). `torch.export` captures the operator
  as one node, so an exported program launches kernel A through the
  same CUDA implementation and counts its launches in `launch_counts`.
  On DTensor operands (the sharded LM step) the operator runs by the
  sharding rule `core.mesh` registers -- batch or heads split, never
  the sequence -- on each rank's local shards, its backward too
  (`_local_backward`).
- `flash_attention(q, k, v, *, causal, key_lens, window, block_q,
  block_k)`: the public function with the JAX checks, over `flash_fwd`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops import _cuda

NEG_INF = -1e30

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 512

#: launches of the flash forward kernel (reset with reset_launch_counts);
#: "fwd_window" counts the launches among them that had a window
launch_counts = {"fwd": 0, "fwd_window": 0}

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
    launch_counts["fwd_window"] += window is not None
    return o, lse


def _pad_keys(x, size):
    """Zero-pad dim 2 (T) of a [B, H, T, D] tensor to `size`."""
    pad = size - x.shape[2]
    return x if pad == 0 else torch.nn.functional.pad(x, (0, 0, 0, pad))


def _windowed_backward(qf, gf, delta, lse, kf, vf, lens, *, t: int,
                       block_k: int, window: int):
    """Sliding-window backward over [B, H, T, D] f32 (qf already scaled):
    key block j only meets queries [j*bk, j*bk + bk + window - 1), so each
    block gathers just that query span. Returns f32 (dq unscaled, dk,
    dv)."""
    b, h, _, d = qf.shape
    t_kv = kf.shape[2]
    window = min(window, t)
    tk_pad = -(-t_kv // block_k) * block_k
    span = block_k + window - 1
    kp, vp = _pad_keys(kf, tk_pad), _pad_keys(vf, tk_pad)
    qp, gp = _pad_keys(qf, tk_pad + span), _pad_keys(gf, tk_pad + span)
    deltap = _pad_keys(delta[..., None], tk_pad + span)
    lsep = _pad_keys(lse[..., None], tk_pad + span)
    dq = torch.zeros((b, h, tk_pad + span, d), dtype=torch.float32,
                     device=qf.device)
    dk = torch.empty((b, h, tk_pad, d), dtype=torch.float32,
                     device=qf.device)
    dv = torch.empty_like(dk)
    kpos_base = torch.arange(block_k, device=qf.device)
    qwin_base = torch.arange(span, device=qf.device)
    lens_b = lens.long().view(b, 1, 1, 1)
    for j in range(tk_pad // block_k):
        start = j * block_k
        keys, rows = slice(start, start + block_k), slice(start,
                                                          start + span)
        kj, vj = kp[:, :, keys], vp[:, :, keys]
        qs, gs = qp[:, :, rows], gp[:, :, rows]
        kpos = start + kpos_base
        qpos = start + qwin_base
        valid = kpos[None, None, None, :] < lens_b
        band = ((qpos[:, None] >= kpos[None, :])
                & (qpos[:, None] - kpos[None, :] < window)
                & (qpos < t)[:, None])
        valid = valid & band
        # p = where(valid, exp(s - lse), 0), computed in place in s
        p = torch.matmul(qs, kj.transpose(-1, -2))
        p = p.sub_(lsep[:, :, rows]).exp_().masked_fill_(~valid, 0.0)
        dv[:, :, keys] = torch.matmul(p.transpose(-1, -2), gs)
        # ds = p * (dp - delta), in place in dp
        ds = torch.matmul(gs, vj.transpose(-1, -2))
        ds = ds.sub_(deltap[:, :, rows]).mul_(p)
        dk[:, :, keys] = torch.matmul(ds.transpose(-1, -2), qs)
        dq[:, :, rows] += torch.matmul(ds, kj)
    return dq[:, :, :t], dk[:, :, :t_kv], dv[:, :, :t_kv]


def _blockwise_backward(qf, gf, delta, lse, kf, vf, lens, *, causal: bool,
                        block_k: int):
    """Backward over [B, H, T, D] f32 (qf already scaled), every query
    against each key block in turn; causal blocks are masked, not
    skipped, as in the JAX package. Returns f32 (dq unscaled, dk, dv)."""
    b, h, t, d = qf.shape
    t_kv = kf.shape[2]
    tk_pad = -(-t_kv // block_k) * block_k
    kp, vp = _pad_keys(kf, tk_pad), _pad_keys(vf, tk_pad)
    dq = torch.zeros_like(qf)
    dk = torch.empty((b, h, tk_pad, d), dtype=torch.float32,
                     device=qf.device)
    dv = torch.empty_like(dk)
    kpos_base = torch.arange(block_k, device=qf.device)
    qpos = torch.arange(t, device=qf.device)
    lens_b = lens.long().view(b, 1, 1, 1)
    lse_col, delta_col = lse[..., None], delta[..., None]
    for j in range(tk_pad // block_k):
        keys = slice(j * block_k, (j + 1) * block_k)
        kj, vj = kp[:, :, keys], vp[:, :, keys]
        kpos = j * block_k + kpos_base
        valid = kpos[None, None, None, :] < lens_b
        if causal:
            valid = valid & (qpos[:, None] >= kpos[None, :])
        # p = where(valid, exp(s - lse), 0), computed in place in s
        p = torch.matmul(qf, kj.transpose(-1, -2))
        p = p.sub_(lse_col).exp_().masked_fill_(~valid, 0.0)
        dv[:, :, keys] = torch.matmul(p.transpose(-1, -2), gf)
        # ds = p * (dp - delta), in place in dp
        ds = torch.matmul(gf, vj.transpose(-1, -2))
        ds = ds.sub_(delta_col).mul_(p)
        dq += torch.matmul(ds, kj)
        dk[:, :, keys] = torch.matmul(ds.transpose(-1, -2), qf)
    return dq, dk[:, :, :t_kv], dv[:, :, :t_kv]


def flash_backward(q, k, v, lens, o, lse, g, *, causal: bool,
                   block_k: int = DEFAULT_BLOCK_K,
                   window: Optional[int] = None):
    """(dq, dk, dv) of flash attention, each in its input's dtype and
    [B, T, H, D] layout. q [B, Tq, H, D]; k, v [B, Tk, H, D]; lens [B]
    int; o the forward's output (q's dtype); lse [B, H, Tq] f32; g the
    cotangent of o. Recomputes p block by block over `block_k` keys, in
    f32, from lse and delta = sum(g * o)."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    heads = lambda x: x.float().permute(0, 2, 1, 3)       # [B, H, T, D]
    qf = heads(q) * scale
    gf = heads(g)
    delta = torch.sum(gf * heads(o), dim=-1)               # [B, H, Tq]
    kf, vf = heads(k), heads(v)
    if window is not None:
        dq, dk, dv = _windowed_backward(qf, gf, delta, lse, kf, vf, lens,
                                        t=q.shape[1], block_k=block_k,
                                        window=window)
    else:
        dq, dk, dv = _blockwise_backward(qf, gf, delta, lse, kf, vf, lens,
                                         causal=causal, block_k=block_k)
    back = lambda x, like: x.permute(0, 2, 1, 3).to(like.dtype)
    return back(dq * scale, q), back(dk, k), back(dv, v)


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lens: torch.Tensor, causal: bool, window: Optional[int],
              block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of flash attention: kernel A on CUDA tensors, the plain
    version on CPU tensors (looked up at call time, so a caller may
    stand a counting version in for either). o is contiguous, as the
    kernel writes it."""
    o, lse = flash_attention_reference(q, k, v, lens, causal=causal,
                                       window=window)
    return o.contiguous(), lse


@flash_fwd.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, lens, causal, window, block_k):
    return flash_kernel(q, k, v, lens, causal=causal, window=window)


_cuda.skip_dynamo_guard(flash_fwd)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, lens, causal, window, block_k):
    b, tq, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, tq), dtype=torch.float32))


def _flash_setup(ctx, inputs, output):
    q, k, v, lens, causal, window, block_k = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, lens, o, lse)
    ctx.causal, ctx.window, ctx.block_k = causal, window, block_k


def _flash_grad(ctx, g, g_lse):
    q, k, v, lens, o, lse = ctx.saved_tensors
    back = lambda *t: flash_backward(*t, causal=ctx.causal,
                                     block_k=ctx.block_k, window=ctx.window)
    if _is_dtensor(q):
        return _local_backward(back, q, k, v, lens, o, lse, g) + (None,) * 4
    dq, dk, dv = back(q, k, v, lens, o, lse, g)
    return dq, dk, dv, None, None, None, None


def _is_dtensor(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _local_backward(back, q, k, v, lens, o, lse, g):
    """The backward of DTensor operands, shard by shard. The operator's
    sharding rule (`core.mesh`) splits batch and heads alike on q, k, v
    and o, so each rank's gradients are those of its own shards. The
    saved inputs are as the caller passed them (the rule's
    redistribution runs below autograd): q, k, v and g come to o's
    placements, lens [B] to o's batch split, first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, at = o.device_mesh, o.placements
    if not _is_dtensor(lens):
        lens = DTensor.from_local(lens, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    lens = lens.redistribute(mesh, [p if p == Shard(0) else Replicate()
                                    for p in at])
    q, k, v, g = (t.redistribute(mesh, at) for t in (q, k, v, g))
    grads = back(*(t.to_local() for t in (q, k, v, lens, o, lse, g)))
    # the gradients come back as permuted views: contiguous, as the
    # DTensor's (contiguous) strides say
    return tuple(DTensor.from_local(d.contiguous(), mesh, at,
                                    run_check=False, shape=like.shape,
                                    stride=like.stride())
                 for d, like in zip(grads, (q, k, v)))


flash_fwd.register_autograd(_flash_grad, setup_context=_flash_setup)


def flash_attention(q, k, v, *, causal: bool = False, key_lens=None,
                    window: Optional[int] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """Fused scaled-dot-product attention, differentiable.

    q: [B, Tq, H, D]; k, v: [B, Tkv, H, D]. Returns [B, Tq, H, D].
    key_lens: optional [B] int -- row b
    attends only keys [0, lens[b]). window: sliding-window attention
    (query t attends keys (t-window, t]); requires causal=True. Causal
    attention requires Tq == Tkv. block_k: the backward's key block;
    block_q is taken for the JAX signature and changes no number (the
    kernel picks its own tiles)."""
    if q.ndim != 4:
        raise ValueError(f"expected [B, T, H, D], got {tuple(q.shape)}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q and block_k must be >= 1, got "
                         f"{block_q}, {block_k}")
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
    return flash_fwd(q, k, v, lens, causal, window, block_k)[0]
