"""Recurrent layers over the module system (port of
`paddle_tpu.nn.recurrent`). Inputs are dense padded [B, T, F] plus
optional lengths [B]; `MDLSTM`'s are grids [B, H, W, F].

`impl` selects the time loop (`ops.rnn.lstm`, `ops.rnn.gru`): None runs
the fused kernels (D and E, or F and G) on CUDA tensors and their plain
versions on CPU tensors; "torch" the plain versions; "kernel" the
kernels; "scan" the masked scan under autograd. It replaces the JAX
package's `PADDLE_TPU_RNN_IMPL` environment override.
"""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.nn.module import Layer, ShapeSpec
from paddle_tpu_torch.ops import rnn as rnn_ops


def _check_impl(impl):
    if impl not in rnn_ops.IMPLS:
        raise ValueError(f"impl must be one of {rnn_ops.IMPLS}, got "
                         f"{impl!r}")
    return impl


class LSTM(Layer):
    """Unidirectional LSTM; returns [B, T, H] outputs."""

    def __init__(self, hidden: int, *, reverse: bool = False,
                 name: Optional[str] = None, impl=None):
        self.hidden = hidden
        self.reverse = reverse
        self.name = name
        self.impl = _check_impl(impl)

    def _init(self, rng, spec: ShapeSpec, lengths_spec=None,
              _abstract=False):
        b, t, f = spec.shape
        out = ShapeSpec((b, t, self.hidden), spec.dtype)
        if _abstract:
            return {}, {}, out
        return rnn_ops.init_lstm_params(rng, f, self.hidden), {}, out

    def _apply(self, params, state, x, lengths=None, *, training: bool,
               rng):
        out, _ = rnn_ops.lstm(params, x, lengths, reverse=self.reverse,
                              impl=self.impl)
        return out, {}


class GRU(Layer):
    """Unidirectional GRU; returns [B, T, H] outputs."""

    def __init__(self, hidden: int, *, reverse: bool = False,
                 name: Optional[str] = None, impl=None):
        self.hidden = hidden
        self.reverse = reverse
        self.name = name
        self.impl = _check_impl(impl)

    def _init(self, rng, spec: ShapeSpec, lengths_spec=None,
              _abstract=False):
        b, t, f = spec.shape
        out = ShapeSpec((b, t, self.hidden), spec.dtype)
        if _abstract:
            return {}, {}, out
        return rnn_ops.init_gru_params(rng, f, self.hidden), {}, out

    def _apply(self, params, state, x, lengths=None, *, training: bool,
               rng):
        out, _ = rnn_ops.gru(params, x, lengths, reverse=self.reverse,
                             impl=self.impl)
        return out, {}


class MDLSTM(Layer):
    """2-D multi-dimensional LSTM over a [B, H, W, F] grid
    (`ops.rnn.md_lstm`); reverse_rows / reverse_cols scan from any of the
    four corners. No kernel: torch ops under autograd."""

    def __init__(self, hidden: int, *, reverse_rows: bool = False,
                 reverse_cols: bool = False, name: Optional[str] = None):
        self.hidden = hidden
        self.reverse_rows = reverse_rows
        self.reverse_cols = reverse_cols
        self.name = name

    def _init(self, rng, spec: ShapeSpec, _abstract=False):
        b, h, w, f = spec.shape
        out = ShapeSpec((b, h, w, self.hidden), spec.dtype)
        if _abstract:
            return {}, {}, out
        # drawn on the CPU; Layer.init moves the tree to its device
        return rnn_ops.init_md_lstm_params(rng, f, self.hidden,
                                           device="cpu"), {}, out

    def _apply(self, params, state, x, *, training: bool, rng):
        out = rnn_ops.md_lstm(params, x, reverse_rows=self.reverse_rows,
                              reverse_cols=self.reverse_cols)
        return out, {}


class BiLSTM(Layer):
    """Bidirectional LSTM, concat output [B, T, 2H]."""

    def __init__(self, hidden: int, name: Optional[str] = None, impl=None):
        self.hidden = hidden
        self.name = name
        self.impl = _check_impl(impl)

    def _init(self, rng, spec: ShapeSpec, lengths_spec=None,
              _abstract=False):
        b, t, f = spec.shape
        out = ShapeSpec((b, t, 2 * self.hidden), spec.dtype)
        if _abstract:
            return {}, {}, out
        params = {
            "fwd": rnn_ops.init_lstm_params(rng, f, self.hidden),
            "bwd": rnn_ops.init_lstm_params(rng, f, self.hidden),
        }
        return params, {}, out

    def _apply(self, params, state, x, lengths=None, *, training: bool,
               rng):
        out, _ = rnn_ops.bidirectional(rnn_ops.lstm, params["fwd"],
                                       params["bwd"], x, lengths,
                                       impl=self.impl)
        return out, {}
