"""The fused LSTM time loop (port of `paddle_tpu.ops.pallas_lstm`).

- `lstm_forward_reference`, `lstm_backward_reference`: the plain PyTorch
  versions of the two TPU kernels -- the step loop of `_fwd_kernel` and
  the reverse loop of `_bwd_kernel`, written out (not autograd). In
  bf16 the backward recomputes the gates from `hs` (x_proj's dtype), as
  the TPU kernel does, so it differs slightly from autograd through the
  plain scan; that is the reference's behaviour.
- `lstm_forward_kernel`, `lstm_backward_kernel`: the wrappers of
  `csrc/fused_lstm.cu` (kernels D and E). D is a memset of its barrier
  counters and one cooperative launch of the forward time loop over row
  groups x unit groups (`time_loop.forward_geometry`); E is three
  launches on the stream (the gates of every step, the serial loop as
  one cooperative launch, dW_hh) plus one that sums dW's split parts.
  CUDA tensors only; they raise on what the kernels do not take and
  count one launch per call in `launch_counts` (their device operations
  in `device_launches`). Where gradients are wanted, `fused_lstm` checks
  E's geometry before D runs.
- `fused_lstm(x_proj, w_hh, h0, c0, bounds, *, impl=None)`: the
  `custom_vjp` as a `torch.autograd.Function`. impl None runs the
  kernels on CUDA tensors and the plain versions on CPU tensors;
  "torch" the plain versions anywhere; "kernel" the kernels (a CPU
  tensor raises).
- `make_bounds`: the per-row `[start, end)` step windows.

Shapes: x_proj [T, B, 4H] (f32 or bf16), w_hh [H, 4H] (f32 or bf16, gate
order i, f, g, o), h0/c0 [B, H], bounds [B, 2] int32. Returns hs [T, B,
H] in x_proj's dtype, h_last = hs[-1] and c_last = cs[-1] in c0's dtype,
with the carries f32 throughout. There is no `fits_vmem` gate: a shape
the kernels do not take raises ValueError naming the limit.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.ops import time_loop as TL

#: launches of kernel D ("fwd") and kernel E ("bwd")
launch_counts = {"fwd": 0, "bwd": 0}
#: device operations made by the kernels' calls: D's counters' memset
#: and its loop; E's three phases and the sum of dW's split parts where
#: dW is split
device_launches = {"fwd": 0, "bwd": 0}

_WHAT = "fused_lstm kernel"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lstm_device_limits": [_P],
    "lstm_fwd": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_longlong,
                 _P],
    "lstm_bwd_gates": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "lstm_bwd_loop": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      ctypes.c_longlong, _P],
    "lstm_bwd_dw": [_I, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
                    _P],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
        device_launches[k] = 0


def make_bounds(b: int, t: int, lengths, reverse: bool, device=None):
    """Per-row [start, end) step window [B, 2] int32: forward sequences
    occupy [0, len); time-flipped ones occupy [T-len, T)."""
    if lengths is None:
        lo = torch.zeros((b, 1), dtype=torch.int32, device=device)
        hi = torch.full((b, 1), t, dtype=torch.int32, device=device)
    else:
        ln = lengths.to(device=device, dtype=torch.int32)[:, None]
        full = torch.full((b, 1), t, dtype=torch.int32, device=device)
        lo = (t - ln) if reverse else torch.zeros_like(ln)
        hi = full if reverse else ln
    return torch.cat([lo, hi], dim=1)


# -- the plain versions --------------------------------------------------------


def _operand(x, w_dtype):
    """x rounded to the weight's dtype, then f32: the TPU kernel's
    `x.astype(w_hh.dtype)` fed to an f32-accumulating product."""
    return x.to(w_dtype).float()


def _gates(x_proj_t, hprev, w_hh, hidden):
    g = x_proj_t.float() + _operand(hprev, w_hh.dtype) @ w_hh.float()
    return (torch.sigmoid(g[:, :hidden]), torch.sigmoid(g[:, hidden:2 * hidden]),
            torch.tanh(g[:, 2 * hidden:3 * hidden]),
            torch.sigmoid(g[:, 3 * hidden:]))


def _live(bounds, t):
    """[B, 1] bool: is step t inside each row's [start, end) window."""
    return ((bounds[:, :1] <= t) & (t < bounds[:, 1:2]))


def lstm_forward_reference(x_proj, w_hh, h0, c0, bounds):
    """The step loop of `_fwd_kernel`: returns (hs [T, B, H] in x_proj's
    dtype, cs [T, B, H] f32)."""
    steps, _, g4 = x_proj.shape
    hidden = g4 // 4
    h, c = h0.float(), c0.float()
    hs, cs = [], []
    for t in range(steps):
        i, f, g, o = _gates(x_proj[t], h, w_hh, hidden)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = _live(bounds, t)
        h = torch.where(m, h_new, h)          # masked steps carry through
        c = torch.where(m, c_new, c)
        hs.append(h.to(x_proj.dtype))
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_backward_reference(x_proj, w_hh, h0, c0, bounds, hs, cs, dhs,
                            dh_last, dc_last):
    """The reverse loop of `_bwd_kernel`: returns (dxp in x_proj's
    dtype, dW_hh f32, dh0 f32, dc0 f32)."""
    steps, _, g4 = x_proj.shape
    hidden = g4 // 4
    w_f = w_hh.float()
    dh_c, dc_c = dh_last.float(), dc_last.float()
    dw = torch.zeros(w_hh.shape, dtype=torch.float32, device=w_hh.device)
    dxp = torch.empty_like(x_proj)
    for t in reversed(range(steps)):
        hprev = hs[t - 1].float() if t > 0 else h0.float()
        cprev = cs[t - 1] if t > 0 else c0.float()
        i, f, g, o = _gates(x_proj[t], hprev, w_hh, hidden)
        tanh_c = torch.tanh(cs[t])
        dh = dhs[t].float() + dh_c
        do = dh * tanh_c * o * (1.0 - o)
        dc = dc_c + dh * o * (1.0 - tanh_c * tanh_c)
        di = dc * g * i * (1.0 - i)
        df = dc * cprev * f * (1.0 - f)
        dg = dc * i * (1.0 - g * g)
        m = _live(bounds, t)
        dgates = torch.where(m, torch.cat([di, df, dg, do], dim=-1), 0.0)
        dxp[t] = dgates.to(dxp.dtype)
        dgates_c = _operand(dgates, w_hh.dtype)
        # masked steps are identity: the whole cotangent passes through
        dh_c = torch.where(m, dgates_c @ w_f.T, dh)
        dc_c = torch.where(m, dc * f, dc_c)
        dw += _operand(hprev, w_hh.dtype).T @ dgates_c
    return dxp, dw, dh_c, dc_c


# -- the kernels ---------------------------------------------------------------


def geometry(batch: int, hidden: int, sms: int, smem_optin: int):
    """D's forward loop: `time_loop.forward_geometry` over 4 gate columns
    per unit. Raises ValueError on a shape the kernel does not take."""
    return TL.forward_geometry(_WHAT, batch, hidden, 4, sms, smem_optin)


def backward_geometry(batch: int, hidden: int, sms: int, smem_optin: int):
    """E's serial loop: `time_loop.backward_geometry` over 4H columns."""
    return TL.backward_geometry(_WHAT, batch, hidden, 4, sms, smem_optin)


def device_limits(device):
    """(SM count, opt-in shared memory per block) of the card, read once
    per device; raises if it has no cooperative launches."""
    return TL.device_limits("fused_lstm", _SIGNATURES, "lstm_device_limits",
                            device)


def _check(x_proj, w_hh, h0, c0, bounds):
    """`time_loop.check_inputs`, and c0 like h0. Returns (T, B, H)."""
    steps, b, hidden = TL.check_inputs(_WHAT, x_proj, w_hh, h0, bounds, 4)
    if tuple(c0.shape) != (b, hidden):
        raise ValueError(f"{_WHAT}: c0 must be [B, H] = ({b}, {hidden}), "
                         f"got {tuple(c0.shape)}")
    if c0.device != x_proj.device:
        raise ValueError(f"{_WHAT}: c0 is on {c0.device}, x_proj on "
                         f"{x_proj.device}")
    return steps, b, hidden


def lstm_forward_kernel(x_proj, w_hh, h0, c0, bounds):
    """Launch kernel D (csrc/fused_lstm.cu `lstm_fwd`: a memset of the
    barrier counters, then the forward loop) on the current stream. Same
    contract as lstm_forward_reference."""
    steps, b, hidden = _check(x_proj, w_hh, h0, c0, bounds)
    geo = geometry(b, hidden, *device_limits(x_proj.device))
    lib = _cuda.library("fused_lstm", _SIGNATURES)
    dev = x_proj.device
    x_proj, w_hh = x_proj.contiguous(), w_hh.contiguous()
    h0f, c0f = h0.float().contiguous(), c0.float().contiguous()
    bounds = bounds.contiguous()
    ldo = TL.operand_ld(hidden)
    hs = torch.empty((steps, b, hidden), dtype=x_proj.dtype, device=dev)
    cs = torch.empty((steps, b, hidden), dtype=torch.float32, device=dev)
    opnd = torch.empty((2, b, ldo), dtype=w_hh.dtype, device=dev)
    wt = torch.empty((1,) if geo.resident else (4 * hidden, hidden),
                     dtype=w_hh.dtype, device=dev)
    counters = torch.empty(geo.row_groups + 1, dtype=torch.int32,
                           device=dev)
    err = lib.lstm_fwd(
        TL.DTYPE_CODE[x_proj.dtype], TL.DTYPE_CODE[w_hh.dtype],
        geo.unit_tile, geo.rep, int(geo.resident), x_proj.data_ptr(),
        w_hh.data_ptr(), wt.data_ptr(), h0f.data_ptr(), c0f.data_ptr(),
        bounds.data_ptr(), hs.data_ptr(), cs.data_ptr(), opnd.data_ptr(),
        ldo, counters.data_ptr(), steps, b, hidden, geo.hb, geo.br,
        geo.chunk, geo.threads, geo.smem,
        torch.cuda.current_stream(dev).cuda_stream)
    TL.launch_error(err, "lstm_fwd")
    device_launches["fwd"] += 2     # the counters' memset and the loop
    launch_counts["fwd"] += 1
    return hs, cs


def lstm_backward_kernel(x_proj, w_hh, h0, c0, bounds, hs, cs, dhs,
                         dh_last, dc_last, *, events=None):
    """Launch kernel E (csrc/fused_lstm.cu `lstm_bwd_gates`,
    `lstm_bwd_loop`, `lstm_bwd_dw`) on the current stream. Same contract
    as lstm_backward_reference. `events`, four timing CUDA events or
    None, are recorded before phase 1 and after each phase."""
    steps, b, hidden = _check(x_proj, w_hh, h0, c0, bounds)
    for name, t, dt in (("hs", hs, x_proj.dtype), ("cs", cs, torch.float32)):
        if tuple(t.shape) != (steps, b, hidden) or t.dtype != dt:
            raise ValueError(f"fused_lstm kernel: {name} must be {dt} "
                             f"[T, B, H]")
    sms, smem_optin = device_limits(x_proj.device)
    geo = backward_geometry(b, hidden, sms, smem_optin)
    splits, kchunk = TL.dw_splits(steps * b, hidden, 4, sms)
    lib = _cuda.library("fused_lstm", _SIGNATURES)
    dev = x_proj.device
    f32 = torch.float32
    g4 = 4 * hidden
    x_proj, w_hh = x_proj.contiguous(), w_hh.contiguous()
    h0f, c0f, bounds, hs, cs, dhs, dhl, dcl = (t.contiguous() for t in (
        h0.float(), c0.float(), bounds, hs, cs, dhs.to(x_proj.dtype),
        dh_last.float(), dc_last.float()))
    codes = (TL.DTYPE_CODE[x_proj.dtype], TL.DTYPE_CODE[w_hh.dtype])
    ldo = TL.operand_ld(g4)
    dxp = torch.empty_like(x_proj)
    dw = torch.empty(w_hh.shape, dtype=f32, device=dev)
    dh0 = torch.empty((b, hidden), dtype=f32, device=dev)
    dc0 = torch.empty((b, hidden), dtype=f32, device=dev)
    gates = torch.empty((steps, b, hidden, 4), dtype=f32, device=dev)
    opnd = torch.empty((steps, b, ldo), dtype=w_hh.dtype, device=dev)
    counters = torch.empty(geo.row_groups, dtype=torch.int32, device=dev)
    part = torch.empty((splits, hidden, g4) if splits > 1 else (1,),
                       dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)
    TL.record(events, 0)
    err = lib.lstm_bwd_gates(*codes, x_proj.data_ptr(), w_hh.data_ptr(),
                             h0f.data_ptr(), hs.data_ptr(), gates.data_ptr(),
                             counters.data_ptr(), geo.row_groups, steps, b,
                             hidden, stream)
    TL.launch_error(err, "lstm_bwd_gates")
    device_launches["bwd"] += 1
    TL.record(events, 1)
    err = lib.lstm_bwd_loop(
        *codes, geo.unit_tile, geo.rep, int(geo.resident), gates.data_ptr(), c0f.data_ptr(),
        bounds.data_ptr(), cs.data_ptr(), dhs.data_ptr(), dhl.data_ptr(),
        dcl.data_ptr(), w_hh.data_ptr(), dxp.data_ptr(), opnd.data_ptr(),
        ldo, dh0.data_ptr(), dc0.data_ptr(), counters.data_ptr(), steps, b,
        hidden, geo.hb, geo.br, geo.chunk, geo.threads, geo.smem, stream)
    TL.launch_error(err, "lstm_bwd_loop")
    device_launches["bwd"] += 1
    TL.record(events, 2)
    err = lib.lstm_bwd_dw(*codes, hs.data_ptr(), h0f.data_ptr(),
                          opnd.data_ptr(), ldo, part.data_ptr(),
                          dw.data_ptr(), steps, b, hidden, splits, kchunk,
                          ctypes.addressof(launched), stream)
    device_launches["bwd"] += launched.value
    TL.launch_error(err, "lstm_bwd_dw")
    TL.record(events, 3)
    launch_counts["bwd"] += 1
    return dxp, dw, dh0, dc0


# -- the autograd Function -----------------------------------------------------


class _FusedLSTM(torch.autograd.Function):
    """`fused_lstm`'s custom_vjp: forward returns (hs, h_last, c_last),
    backward receives (dhs, dh_last, dc_last); bounds gets no gradient."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, c0, bounds, use_kernel):
        if use_kernel and any(ctx.needs_input_grad[:4]):
            # E takes fewer shapes than D: refuse before the step starts
            _, b, hidden = _check(x_proj, w_hh, h0, c0, bounds)
            backward_geometry(b, hidden, *device_limits(x_proj.device))
        fwd = lstm_forward_kernel if use_kernel else lstm_forward_reference
        hs, cs = fwd(x_proj, w_hh, h0, c0, bounds)
        ctx.save_for_backward(x_proj, w_hh, h0, c0, bounds, hs, cs)
        ctx.use_kernel = use_kernel
        return hs, hs[-1].clone(), cs[-1].to(c0.dtype, copy=True)

    @staticmethod
    def backward(ctx, dhs, dh_last, dc_last):
        x_proj, w_hh, h0, c0, bounds, hs, cs = ctx.saved_tensors
        bwd = lstm_backward_kernel if ctx.use_kernel else \
            lstm_backward_reference
        dxp, dw, dh0, dc0 = bwd(x_proj, w_hh, h0, c0, bounds, hs, cs, dhs,
                                dh_last, dc_last)
        return (dxp, dw.to(w_hh.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype),
                None, None)


def fused_lstm(x_proj, w_hh, h0, c0, bounds, *, impl=None):
    """Fused scan: returns (hs [T, B, H], h_last [B, H], c_last [B, H]).
    impl None: the kernels for CUDA tensors, the plain versions for CPU
    tensors; "torch": the plain versions; "kernel": the kernels."""
    if impl not in (None, "torch", "kernel"):
        raise ValueError(f"impl must be None|torch|kernel, got {impl!r}")
    use_kernel = impl == "kernel" or (impl is None and x_proj.is_cuda)
    return _FusedLSTM.apply(x_proj, w_hh, h0, c0, bounds, use_kernel)
