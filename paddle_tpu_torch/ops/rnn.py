"""Recurrent cells and runners (port of the LSTM, GRU and tanh-RNN parts
of `paddle_tpu.ops.rnn`).

Layout: inputs [B, T, F] ("batch major"), run time-major inside.
Variable lengths are handled by masking: finished steps carry the state
through unchanged, and outputs past each length are zeroed.

`lstm`, `gru` and `simple_rnn` hoist the input projection (one
[B*T, F] x [F, gates*H] product, through torch's autograd) and run the
h @ W_hh recurrence through a fused time loop -- `ops.fused_lstm`
(kernels D and E), `ops.fused_gru` (F and G), `ops.fused_rnn` (H and I):
the kernels on CUDA tensors, their plain versions on CPU tensors -- or,
with impl="scan", through the masked scan of the step function
differentiated by autograd (the JAX package's `impl="xla"` path). The
JAX `PADDLE_TPU_RNN_IMPL` override is the `impl` argument here (and of
`nn.LSTM`/`nn.GRU`); there is no environment variable. MD-LSTM is not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from paddle_tpu_torch.core.dtypes import default_policy
from paddle_tpu_torch.nn.initializers import as_rng, uniform_between
from paddle_tpu_torch.ops import fused_gru as FG
from paddle_tpu_torch.ops import fused_lstm as FL
from paddle_tpu_torch.ops import fused_rnn as FR
from paddle_tpu_torch.ops import linalg

IMPLS = (None, "torch", "kernel", "scan")


class LSTMState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


def lstm_step_from_proj(params, x_proj_t, state: LSTMState, *,
                        activation=torch.tanh,
                        gate_activation=torch.sigmoid):
    """One LSTM step given the pre-projected input x @ W_ih + b [.., 4H]
    (gate order i, f, g, o)."""
    h, c = state
    gates = x_proj_t + linalg.matmul(h, params["w_hh"])
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i = gate_activation(i)
    f = gate_activation(f)
    g = activation(g)
    o = gate_activation(o)
    new_c = f * c + i * g
    new_h = o * activation(new_c)
    return LSTMState(new_h, new_c)


def lstm_step(params, x_t, state: LSTMState, *, activation=torch.tanh,
              gate_activation=torch.sigmoid):
    """One LSTM step. params: {w_ih [F, 4H], w_hh [H, 4H], b [4H]}."""
    x_proj = linalg.matmul(x_t, params["w_ih"]) + params["b"]
    return lstm_step_from_proj(params, x_proj, state, activation=activation,
                               gate_activation=gate_activation)


def gru_step_from_proj(params, x_proj_t, h, *, activation=torch.tanh,
                       gate_activation=torch.sigmoid):
    """One GRU step given the pre-projected input x @ W_ih + b [.., 3H]
    (gate order r, z, n): n = act(xn + r * hn), h' = (1 - z) n + z h."""
    h_proj = linalg.matmul(h, params["w_hh"])
    xr, xz, xn = torch.chunk(x_proj_t, 3, dim=-1)
    hr, hz, hn = torch.chunk(h_proj, 3, dim=-1)
    r = gate_activation(xr + hr)
    z = gate_activation(xz + hz)
    n = activation(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_step(params, x_t, h, *, activation=torch.tanh,
             gate_activation=torch.sigmoid):
    """One GRU step. params: {w_ih [F, 3H], w_hh [H, 3H], b [3H]}."""
    x_proj = linalg.matmul(x_t, params["w_ih"]) + params["b"]
    return gru_step_from_proj(params, x_proj, h, activation=activation,
                              gate_activation=gate_activation)


def _carry_dtype():
    """Recurrent carries accumulate across T steps: at least f32 even
    under a bf16 compute policy (the gate products still run bf16)."""
    return torch.promote_types(default_policy().accum_dtype, torch.float32)


def _masked_scan(step_fn, init_state, xs, mask, reverse: bool):
    """Scan over time with per-step carry masking for ragged batches.
    The carry is one tensor or a NamedTuple of tensors; xs [T, ...], mask
    [T, B]. Returns (final carry, the carries of every step stacked on a
    leading T axis, in time order)."""
    steps = xs.shape[0]
    single = isinstance(init_state, torch.Tensor)
    carry = (init_state,) if single else init_state
    ys = [None] * steps
    for t in (reversed(range(steps)) if reverse else range(steps)):
        new = step_fn(carry[0] if single else carry, xs[t])
        new = (new,) if single else new
        m = mask[t][:, None]
        # keep the old state where the sequence has ended; cast back so
        # the carry dtype is loop-invariant
        merged = (torch.where(m, n, o).to(o.dtype) for n, o in zip(new, carry))
        carry = tuple(merged) if single else type(carry)(*merged)
        ys[t] = carry
    stacked = [torch.stack(f) for f in zip(*ys)]
    if single:
        return carry[0], stacked[0]
    return carry, type(carry)(*stacked)


def lstm(params, x, lengths=None, *,
         initial_state: Optional[LSTMState] = None, reverse: bool = False,
         impl=None):
    """Run an LSTM over [B, T, F]; returns (outputs [B, T, H], final
    LSTMState).

    reverse=True scans right-to-left (for bidirectional stacks) while
    still respecting per-sequence lengths. impl: None runs the fused time
    loop (`ops.fused_lstm`: the kernels on CUDA tensors, the plain
    versions on CPU tensors); "torch" its plain versions; "kernel" its
    kernels; "scan" the masked scan under autograd."""
    if impl not in IMPLS:
        raise ValueError(f"lstm impl must be one of {IMPLS}, got {impl!r}")
    b, t, _ = x.shape
    hdim = params["w_hh"].shape[0]
    dev = x.device
    if initial_state is None:
        # c is the additive accumulator -> keep it >= f32; h feeds the
        # next step's product anyway, so it can live in the compute dtype
        initial_state = LSTMState(
            torch.zeros((b, hdim), dtype=default_policy().compute_dtype,
                        device=dev),
            torch.zeros((b, hdim), dtype=_carry_dtype(), device=dev))
    if lengths is None:
        mask = torch.ones((b, t), dtype=torch.bool, device=dev)
    else:
        lengths = lengths.to(dev)
        mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]

    # the hoisted input projection: one [B*T, F] x [F, 4H] product; only
    # the h @ W_hh recurrence stays serial
    x_proj = linalg.matmul(x, params["w_ih"]) + params["b"]    # [B, T, 4H]
    xs = x_proj.transpose(0, 1)                                 # [T, B, 4H]

    if impl != "scan":
        xs_f = torch.flip(xs, dims=(0,)) if reverse else xs
        bounds = FL.make_bounds(b, t, lengths, reverse, device=dev)
        hs, h_last, c_last = FL.fused_lstm(
            xs_f.contiguous(), params["w_hh"], initial_state.h,
            initial_state.c, bounds, impl=impl)
        if reverse:
            hs = torch.flip(hs, dims=(0,))
        outputs = hs.transpose(0, 1)
        if lengths is not None:
            outputs = outputs * mask[..., None].to(outputs.dtype)
        return outputs, LSTMState(h_last, c_last)

    def step(state, xp_t):
        return lstm_step_from_proj(params, xp_t, state)

    final, ys = _masked_scan(step, initial_state, xs, mask.transpose(0, 1),
                             reverse)
    outputs = ys.h.transpose(0, 1)                              # [B, T, H]
    # zero out positions past each length so downstream pooling is clean
    outputs = outputs * mask[..., None].to(outputs.dtype)
    return outputs, final


def _mask_and_proj(params, x, lengths):
    """(mask [B, T] bool, lengths on x's device, the hoisted input
    projection time-major [T, B, G])."""
    b, t, _ = x.shape
    dev = x.device
    if lengths is None:
        mask = torch.ones((b, t), dtype=torch.bool, device=dev)
    else:
        lengths = lengths.to(dev)
        mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    x_proj = linalg.matmul(x, params["w_ih"]) + params["b"]
    return mask, lengths, x_proj.transpose(0, 1)


def _run_fused(fused, xs, w_hh, h0, mask, lengths, reverse, impl):
    """A fused GRU/RNN time loop over time-major xs from an f32 h0, in
    the scan path's dtype contract (h0's dtype throughout): (outputs
    [B, T, H], h_last). Outputs are masked only when lengths are given,
    as in the JAX package."""
    t, b, _ = xs.shape
    xs_f = torch.flip(xs, dims=(0,)) if reverse else xs
    bounds = FL.make_bounds(b, t, lengths, reverse, device=xs.device)
    hs, h_last = fused(xs_f.contiguous(), w_hh, h0.float(), bounds,
                       impl=impl)
    if reverse:
        hs = torch.flip(hs, dims=(0,))
    outputs = hs.transpose(0, 1).to(h0.dtype)
    if lengths is not None:
        outputs = outputs * mask[..., None].to(outputs.dtype)
    return outputs, h_last.to(h0.dtype)


def gru(params, x, lengths=None, *, initial_state=None, reverse: bool = False,
        impl=None):
    """Run a GRU over [B, T, F]; returns (outputs [B, T, H], final h).
    impl as in `lstm`: the fused time loop (`ops.fused_gru`, kernels F
    and G on CUDA tensors) or "scan"."""
    if impl not in IMPLS:
        raise ValueError(f"gru impl must be one of {IMPLS}, got {impl!r}")
    b = x.shape[0]
    hdim = params["w_hh"].shape[0]
    if initial_state is None:
        initial_state = torch.zeros((b, hdim), dtype=_carry_dtype(),
                                    device=x.device)
    mask, lengths, xs = _mask_and_proj(params, x, lengths)
    if impl != "scan":
        return _run_fused(FG.fused_gru, xs, params["w_hh"], initial_state,
                          mask, lengths, reverse, impl)

    def step(h, xp_t):
        return gru_step_from_proj(params, xp_t, h)

    final, ys = _masked_scan(step, initial_state, xs, mask.transpose(0, 1),
                             reverse)
    outputs = ys.transpose(0, 1)
    return outputs * mask[..., None].to(outputs.dtype), final


def simple_rnn(params, x, lengths=None, *, activation=torch.tanh,
               reverse: bool = False, impl=None):
    """Vanilla RNN h' = act(x W_ih + h W_hh + b) from h0 = 0; returns
    (outputs [B, T, H], final h). The fused time loop
    (`ops.fused_rnn`, kernels H and I on CUDA tensors) computes tanh
    only: with another activation impl None takes the scan, and "torch"
    or "kernel" (which ask for the fused loop) raise ValueError."""
    if impl not in IMPLS:
        raise ValueError(f"simple_rnn impl must be one of {IMPLS}, got "
                         f"{impl!r}")
    if impl in ("torch", "kernel") and activation is not torch.tanh:
        raise ValueError("the fused simple_rnn time loop supports only "
                         "tanh")
    b = x.shape[0]
    hdim = params["w_hh"].shape[0]
    h0 = torch.zeros((b, hdim), dtype=_carry_dtype(), device=x.device)
    mask, lengths, xs = _mask_and_proj(params, x, lengths)
    if impl != "scan" and activation is torch.tanh:
        return _run_fused(FR.fused_simple_rnn, xs, params["w_hh"], h0, mask,
                          lengths, reverse, impl)

    def step(h, xp_t):
        return activation(xp_t + linalg.matmul(h, params["w_hh"]))

    final, ys = _masked_scan(step, h0, xs, mask.transpose(0, 1), reverse)
    outputs = ys.transpose(0, 1)
    return outputs * mask[..., None].to(outputs.dtype), final


def bidirectional(run_fn, fwd_params, bwd_params, x, lengths=None, **kw):
    """Concat forward and backward passes: ([B, T, 2H], (fwd state, bwd
    state))."""
    fwd_out, fwd_state = run_fn(fwd_params, x, lengths, reverse=False, **kw)
    bwd_out, bwd_state = run_fn(bwd_params, x, lengths, reverse=True, **kw)
    return torch.cat([fwd_out, bwd_out], dim=-1), (fwd_state, bwd_state)


def init_lstm_params(rng, in_features: int, hidden: int,
                     dtype=torch.float32):
    """{w_ih [F, 4H], w_hh [H, 4H] uniform(+-1/sqrt(fan)), b [4H] zero
    with the forget-gate block at 1.0}, as CPU tensors (callers move them
    to their device). rng: an int seed, a numpy RandomState or a CPU
    torch.Generator; the draws differ from `jax.random`'s."""
    rng = as_rng(rng)
    scale = 1.0 / float(in_features) ** 0.5
    hscale = 1.0 / float(hidden) ** 0.5
    b = torch.zeros(4 * hidden, dtype=dtype)
    # forget-gate bias 1.0: standard trick for trainability
    b[hidden:2 * hidden] = 1.0
    return {
        "w_ih": uniform_between(rng, (in_features, 4 * hidden), -scale,
                                scale).to(dtype),
        "w_hh": uniform_between(rng, (hidden, 4 * hidden), -hscale,
                                hscale).to(dtype),
        "b": b,
    }


def _init_gated(rng, in_features: int, hidden: int, gates: int, dtype):
    rng = as_rng(rng)
    scale = 1.0 / float(in_features) ** 0.5
    hscale = 1.0 / float(hidden) ** 0.5
    return {
        "w_ih": uniform_between(rng, (in_features, gates * hidden), -scale,
                                scale).to(dtype),
        "w_hh": uniform_between(rng, (hidden, gates * hidden), -hscale,
                                hscale).to(dtype),
        "b": torch.zeros(gates * hidden, dtype=dtype),
    }


def init_gru_params(rng, in_features: int, hidden: int,
                    dtype=torch.float32):
    """{w_ih [F, 3H], w_hh [H, 3H] uniform(+-1/sqrt(fan)), b [3H] zero},
    as CPU tensors; rng as in init_lstm_params."""
    return _init_gated(rng, in_features, hidden, 3, dtype)


def init_rnn_params(rng, in_features: int, hidden: int,
                    dtype=torch.float32):
    """{w_ih [F, H], w_hh [H, H] uniform(+-1/sqrt(fan)), b [H] zero}, as
    CPU tensors; rng as in init_lstm_params."""
    return _init_gated(rng, in_features, hidden, 1, dtype)
