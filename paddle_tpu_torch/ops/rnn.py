"""LSTM cells and runners (port of the LSTM part of `paddle_tpu.ops.rnn`).

Layout: inputs [B, T, F] ("batch major"), run time-major inside.
Variable lengths are handled by masking: finished steps carry the state
through unchanged, and outputs past each length are zeroed.

`lstm` hoists the input projection (one [B*T, F] x [F, 4H] product,
through torch's autograd) and runs the h @ W_hh recurrence through
`ops.fused_lstm` -- kernels D and E on CUDA tensors, their plain
versions on CPU tensors -- or, with impl="scan", through the masked
scan of `lstm_step_from_proj` differentiated by autograd (the JAX
package's `impl="xla"` path). The JAX `PADDLE_TPU_RNN_IMPL` override is
the `impl` argument here (and of `nn.LSTM`); there is no environment
variable. GRU, the tanh RNN and MD-LSTM wait for their kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from paddle_tpu_torch.core.dtypes import default_policy
from paddle_tpu_torch.nn.initializers import as_rng, uniform_between
from paddle_tpu_torch.ops import fused_lstm as FL
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


def _carry_dtype():
    """Recurrent carries accumulate across T steps: at least f32 even
    under a bf16 compute policy (the gate products still run bf16)."""
    return torch.promote_types(default_policy().accum_dtype, torch.float32)


def _masked_scan(step_fn, init_state, xs, mask, reverse: bool):
    """Scan over time with per-step carry masking for ragged batches.
    xs [T, ...], mask [T, B]; returns (final carry, the carries of every
    step stacked on a leading T axis, in time order)."""
    steps = xs.shape[0]
    carry = init_state
    ys = [None] * steps
    for t in (reversed(range(steps)) if reverse else range(steps)):
        new = step_fn(carry, xs[t])
        m = mask[t][:, None]
        # keep the old state where the sequence has ended; cast back so
        # the carry dtype is loop-invariant
        carry = type(carry)(*(torch.where(m, n, o).to(o.dtype)
                              for n, o in zip(new, carry)))
        ys[t] = carry
    return carry, type(carry)(*(torch.stack(f) for f in zip(*ys)))


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
