"""The fused tanh-RNN time loop (port of `paddle_tpu.ops.pallas_rnn`).

- `rnn_forward_reference`, `rnn_backward_reference`: the plain PyTorch
  versions of the two TPU kernels -- the step loop of `_fwd_kernel` and
  the reverse loop of `_bwd_kernel`, written out (not autograd); the
  backward needs no recomputation: dz = dh (1 - h_t^2) comes from the
  saved f32 stream.
- `rnn_forward_kernel`, `rnn_backward_kernel`: the wrappers of
  `csrc/fused_rnn.cu` (kernels H and I). H is a memset of its barrier
  counters and one cooperative launch of the forward time loop over row
  groups x unit groups (`time_loop.forward_geometry` with one gate
  column); I is a memset of its barrier counters and two launches on
  the stream (the serial loop as one cooperative launch; dW_hh) plus one
  that sums dW's split parts.
  CUDA tensors only; they raise on what the kernels do not take and
  count one launch per call in `launch_counts` (their device operations
  in `device_launches`). Where gradients are wanted, `fused_simple_rnn`
  checks I's geometry before H runs.
- `fused_simple_rnn(x_proj, w_hh, h0, bounds, *, impl=None)`: the
  `custom_vjp` as a `torch.autograd.Function`, with `impl` as in
  `ops.fused_gru.fused_gru`.
- `make_bounds`: the per-row `[start, end)` step windows
  (`ops.fused_lstm.make_bounds`).

Shapes: x_proj [T, B, H] (f32 or bf16), w_hh [H, H] (f32 or bf16), h0
[B, H], bounds [B, 2] int32. Returns hs [T, B, H] in f32 and h_last =
hs[-1] in h0's dtype; the backward gives dxp in x_proj's dtype, dW in
w_hh's and dh0 in h0's. A shape the kernels do not take raises
ValueError naming the limit.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.ops import time_loop as TL
from paddle_tpu_torch.ops.fused_lstm import make_bounds  # noqa: F401

#: launches of kernel H ("fwd") and kernel I ("bwd")
launch_counts = {"fwd": 0, "bwd": 0}
#: device operations made by the kernels' calls: H's counters' memset
#: and its loop; I's counters' memset, its two phases, and the sum of
#: dW's split parts where dW is split
device_launches = {"fwd": 0, "bwd": 0}

_WHAT = "fused_simple_rnn kernel"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rnn_device_limits": [_P],
    "rnn_fwd": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                _I, _I, _I, _I, _I, _I, _I, ctypes.c_longlong, _P],
    "rnn_bwd_loop": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                     _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_longlong,
                     _P],
    "rnn_bwd_dw": [_I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
        device_launches[k] = 0


# -- the plain versions --------------------------------------------------------


def rnn_forward_reference(x_proj, w_hh, h0, bounds):
    """The step loop of `_fwd_kernel`: returns hs [T, B, H] f32."""
    h = h0.float()
    w_f = w_hh.float()
    hs = []
    for t in range(x_proj.shape[0]):
        nh = torch.tanh(x_proj[t].float() + TL.operand(h, w_hh.dtype) @ w_f)
        h = torch.where(TL.live(bounds, t), nh, h)
        hs.append(h)
    return torch.stack(hs)


def rnn_backward_reference(x_proj, w_hh, h0, bounds, hs, dhs, dh_last):
    """The reverse loop of `_bwd_kernel`: returns (dxp in x_proj's dtype,
    dW_hh f32, dh0 f32)."""
    w_f = w_hh.float()
    dh_c = dh_last.float()
    dw = torch.zeros(w_hh.shape, dtype=torch.float32, device=w_hh.device)
    dxp = torch.empty_like(x_proj)
    for t in reversed(range(x_proj.shape[0])):
        hprev = hs[t - 1].float() if t > 0 else h0.float()
        ht = hs[t].float()
        dh = dhs[t].float() + dh_c
        m = TL.live(bounds, t)
        dz = torch.where(m, dh * (1.0 - ht * ht), 0.0)
        dxp[t] = dz.to(dxp.dtype)
        dz_c = TL.operand(dz, w_hh.dtype)
        # masked steps are identity: the whole cotangent passes through
        dh_c = torch.where(m, dz_c @ w_f.T, dh)
        dw += TL.operand(hprev, w_hh.dtype).T @ dz_c
    return dxp, dw, dh_c


# -- the kernels ---------------------------------------------------------------


def geometry(batch: int, hidden: int, sms: int, smem_optin: int):
    """H's forward loop: `time_loop.forward_geometry` over one gate
    column per unit. Raises ValueError on a shape the kernel does not
    take."""
    return TL.forward_geometry(_WHAT, batch, hidden, 1, sms, smem_optin)


def backward_geometry(batch: int, hidden: int, sms: int, smem_optin: int):
    """I's serial loop: `time_loop.backward_geometry` over H columns."""
    return TL.backward_geometry(_WHAT, batch, hidden, 1, sms, smem_optin)


def _limits(device):
    return TL.device_limits("fused_rnn", _SIGNATURES, "rnn_device_limits",
                            device)


def rnn_forward_kernel(x_proj, w_hh, h0, bounds):
    """Launch kernel H (csrc/fused_rnn.cu `rnn_fwd`: a memset of the
    barrier counters, then the forward loop) on the current stream. Same
    contract as rnn_forward_reference."""
    steps, b, hidden = TL.check_inputs(_WHAT, x_proj, w_hh, h0, bounds, 1)
    geo = geometry(b, hidden, *_limits(x_proj.device))
    lib = _cuda.library("fused_rnn", _SIGNATURES)
    dev = x_proj.device
    x_proj, w_hh = x_proj.contiguous(), w_hh.contiguous()
    h0f, bounds = h0.float().contiguous(), bounds.contiguous()
    ldo = TL.operand_ld(hidden)
    hs = torch.empty((steps, b, hidden), dtype=torch.float32, device=dev)
    opnd = torch.empty((2, b, ldo), dtype=w_hh.dtype, device=dev)
    wt = torch.empty((1,) if geo.resident else (hidden, hidden),
                     dtype=w_hh.dtype, device=dev)
    counters = torch.empty(geo.row_groups + 1, dtype=torch.int32,
                           device=dev)
    err = lib.rnn_fwd(
        TL.DTYPE_CODE[x_proj.dtype], TL.DTYPE_CODE[w_hh.dtype],
        geo.unit_tile, geo.rep, int(geo.resident), x_proj.data_ptr(),
        w_hh.data_ptr(), wt.data_ptr(), h0f.data_ptr(), bounds.data_ptr(),
        hs.data_ptr(), opnd.data_ptr(), ldo, counters.data_ptr(), steps, b,
        hidden, geo.hb, geo.br, geo.chunk, geo.threads, geo.smem,
        torch.cuda.current_stream(dev).cuda_stream)
    TL.launch_error(err, "rnn_fwd")
    device_launches["fwd"] += 2     # the counters' memset and the loop
    launch_counts["fwd"] += 1
    return hs


def rnn_backward_kernel(x_proj, w_hh, h0, bounds, hs, dhs, dh_last, *,
                        events=None):
    """Launch kernel I (csrc/fused_rnn.cu `rnn_bwd_loop`, `rnn_bwd_dw`) on
    the current stream. Same contract as rnn_backward_reference (x_proj
    only sets dxp's dtype and shape; I reads the saved stream, not
    x_proj). `events`, four timing CUDA events or None, are recorded as
    E's and G's wrappers record them, with an empty first phase: I has
    no gates phase."""
    steps, b, hidden = TL.check_inputs(_WHAT, x_proj, w_hh, h0, bounds, 1)
    for name, t in (("hs", hs), ("dhs", dhs)):
        if tuple(t.shape) != (steps, b, hidden):
            raise ValueError(f"{_WHAT}: {name} must be [T, B, H]")
    sms, smem_optin = _limits(x_proj.device)
    geo = backward_geometry(b, hidden, sms, smem_optin)
    splits, kchunk = TL.dw_splits(steps * b, hidden, 1, sms)
    lib = _cuda.library("fused_rnn", _SIGNATURES)
    dev = x_proj.device
    f32 = torch.float32
    w_hh = w_hh.contiguous()
    h0f, bounds, hs, dhs, dhl = (t.contiguous() for t in (
        h0.float(), bounds, hs.float(), dhs.float(), dh_last.float()))
    codes = (TL.DTYPE_CODE[x_proj.dtype], TL.DTYPE_CODE[w_hh.dtype])
    dxp = torch.empty(x_proj.shape, dtype=x_proj.dtype, device=dev)
    ldo = TL.operand_ld(hidden)
    opnd = torch.empty((steps, b, ldo), dtype=w_hh.dtype, device=dev)
    dw = torch.empty(w_hh.shape, dtype=f32, device=dev)
    dh0 = torch.empty((b, hidden), dtype=f32, device=dev)
    counters = torch.empty(geo.row_groups, dtype=torch.int32, device=dev)
    part = torch.empty((splits, hidden, hidden) if splits > 1 else (1,),
                       dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)
    TL.record(events, 0)
    TL.record(events, 1)
    err = lib.rnn_bwd_loop(
        *codes, geo.unit_tile, geo.rep, int(geo.resident), hs.data_ptr(),
        dhs.data_ptr(), dhl.data_ptr(), bounds.data_ptr(), w_hh.data_ptr(),
        dxp.data_ptr(), opnd.data_ptr(), ldo, dh0.data_ptr(),
        counters.data_ptr(), steps, b, hidden, geo.hb, geo.br, geo.chunk,
        geo.threads, geo.smem, stream)
    TL.launch_error(err, "rnn_bwd_loop")
    device_launches["bwd"] += 2     # the counters' memset and the loop
    TL.record(events, 2)
    err = lib.rnn_bwd_dw(codes[1], hs.data_ptr(), h0f.data_ptr(),
                         opnd.data_ptr(), ldo, part.data_ptr(),
                         dw.data_ptr(), steps, b, hidden, splits, kchunk,
                         ctypes.addressof(launched), stream)
    device_launches["bwd"] += launched.value
    TL.launch_error(err, "rnn_bwd_dw")
    TL.record(events, 3)
    launch_counts["bwd"] += 1
    return dxp, dw, dh0


# -- the autograd Function -----------------------------------------------------


class _FusedSimpleRNN(torch.autograd.Function):
    """`fused_simple_rnn`'s custom_vjp: forward returns (hs, h_last),
    backward receives (dhs, dh_last); bounds gets no gradient."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, bounds, use_kernel):
        if use_kernel and any(ctx.needs_input_grad[:3]):
            # I and H take different shapes: refuse before the step starts
            _, b, hidden = TL.check_inputs(_WHAT, x_proj, w_hh, h0, bounds, 1)
            backward_geometry(b, hidden, *_limits(x_proj.device))
        fwd = rnn_forward_kernel if use_kernel else rnn_forward_reference
        hs = fwd(x_proj, w_hh, h0, bounds)
        ctx.save_for_backward(x_proj, w_hh, h0, bounds, hs)
        ctx.use_kernel = use_kernel
        return hs, hs[-1].to(h0.dtype, copy=True)

    @staticmethod
    def backward(ctx, dhs, dh_last):
        x_proj, w_hh, h0, bounds, hs = ctx.saved_tensors
        bwd = rnn_backward_kernel if ctx.use_kernel else \
            rnn_backward_reference
        dxp, dw, dh0 = bwd(x_proj, w_hh, h0, bounds, hs, dhs, dh_last)
        return dxp, dw.to(w_hh.dtype), dh0.to(h0.dtype), None, None


def fused_simple_rnn(x_proj, w_hh, h0, bounds, *, impl=None):
    """Fused scan: returns (hs [T, B, H] f32, h_last [B, H]). impl None:
    the kernels for CUDA tensors, the plain versions for CPU tensors;
    "torch": the plain versions; "kernel": the kernels."""
    if impl not in (None, "torch", "kernel"):
        raise ValueError(f"impl must be None|torch|kernel, got {impl!r}")
    use_kernel = impl == "kernel" or (impl is None and x_proj.is_cuda)
    return _FusedSimpleRNN.apply(x_proj, w_hh, h0, bounds, use_kernel)
