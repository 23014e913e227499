"""The recurrent-group engine: user-defined step networks with named
memories, unrolled over time for training and plugged into beam search
for generation (port of `paddle_tpu.nn.recurrent_group`).

The step is a function plus a parameter tree. `run` unrolls it in a
Python loop over time under autograd (the JAX package's `lax.scan`),
masking ragged tails so finished sequences carry their memories through
unchanged. `generate` closes the same step over an embedding of the
previously generated token and hands it to `ops.beam_search`'s
`greedy_search` or `beam_search`, with the statics riding in the decoder
state so beam search tiles and re-gathers them with the memories.

- `Memory`  -- a named recurrent state slot.
- boots     -- zeros by default, or caller-provided tensors (a decoder
  booted from the encoder state).
- statics   -- non-sequence inputs visible at every step (encoder outputs
  for attention).

`scan_subsequences` runs a group within every sub-sequence of a
2-level nested batch; `RecurrentGroupLayer` puts a group in a
`Sequential` stack. The JAX `unroll` option (a `lax.scan` knob) has no
meaning here and is not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from paddle_tpu_torch.core.dtypes import default_policy
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
from paddle_tpu_torch.nn.module import Layer, ShapeSpec, spec_of
from paddle_tpu_torch.ops import beam_search as bs
from paddle_tpu_torch.ops import rnn as rnn_ops


class Memory:
    """One named recurrent state slot.

    size:  feature width (int) or full per-example shape (tuple).
    boot:  "zeros" (default) or "extern" -- the caller must pass a tensor
           for this memory via ``boots=`` at run/generate time.
    dtype: carry dtype; defaults to the policy compute dtype. Use
           torch.float32 for additive accumulators (an LSTM cell state).
    """

    def __init__(self, size: Union[int, Tuple[int, ...]], *,
                 boot: str = "zeros", dtype=None):
        if boot not in ("zeros", "extern"):
            raise ValueError(f"Memory boot must be 'zeros' or 'extern', got "
                             f"{boot!r}")
        self.shape = (size,) if isinstance(size, int) else tuple(size)
        self.boot = boot
        self.dtype = dtype

    def resolved_dtype(self):
        return self.dtype if self.dtype is not None else \
            default_policy().compute_dtype


class FnStep:
    """Step network from two callables.

    init_fn(rng, mem_specs: dict[str, ShapeSpec], x_specs: tuple) -> params
    apply_fn(params, mems: dict[str, Tensor], *x_t_and_statics)
        -> (out, new_mems: dict)

    `out` may be a tensor or a tree of them (stacked across time in
    run()); new_mems must contain every declared memory name.
    """

    def __init__(self, init_fn: Callable, apply_fn: Callable):
        self.init_fn = init_fn
        self.apply_fn = apply_fn

    def init(self, rng, mem_specs, x_specs):
        return self.init_fn(rng, mem_specs, x_specs)

    def apply(self, params, mems, *xs):
        return self.apply_fn(params, mems, *xs)


def _zip_map(fn, new, old):
    """fn over the paired leaves of two trees of one structure (dicts,
    lists, tuples)."""
    if isinstance(old, dict):
        return {k: _zip_map(fn, new[k], old[k]) for k in old}
    if isinstance(old, (list, tuple)):
        return [_zip_map(fn, n, o) for n, o in zip(new, old)]
    return fn(new, old)


def _mask_merge(mask_b, new, old):
    """Where mask is False the sequence has ended: keep the old carry."""

    def one(n, o):
        m = mask_b.reshape(mask_b.shape + (1,) * (n.ndim - 1))
        return torch.where(m, n, o).to(o.dtype)

    return _zip_map(one, new, old)


def _stack_time(outs):
    """Per-step outputs (trees of [B, ...]) -> one tree of [B, T, ...]."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack_time([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack_time([o[i] for o in outs]) for i in range(len(first))]
    return torch.stack(outs, dim=1)


class RecurrentGroup:
    """User step net + named memories -> unrolled training / beam
    generation.

    step:      FnStep (or any object with the same init/apply contract).
    memories:  dict name -> Memory.
    reverse:   run right-to-left (still honoring per-sequence lengths).
    out_ignore_mask: by default per-step outputs at padded positions are
       zeroed (floating leaves only); set True to return them raw.
    """

    def __init__(self, step, memories: Dict[str, Memory], *,
                 reverse: bool = False, out_ignore_mask: bool = False):
        self.step = step
        self.memories = dict(memories)
        self.reverse = reverse
        self.out_ignore_mask = out_ignore_mask

    # ---- init -------------------------------------------------------
    def init(self, rng, *x_specs, batch: int = 1):
        """Initialize step parameters. x_specs are per-timestep input specs
        WITHOUT the time axis ([B, F...]), plus any static specs, in the
        order the step's apply receives them."""
        mem_specs = {
            name: ShapeSpec((batch,) + m.shape, m.resolved_dtype())
            for name, m in self.memories.items()
        }
        return self.step.init(rng, mem_specs,
                              tuple(spec_of(s) for s in x_specs))

    def _boot(self, batch: int, boots: Optional[Dict[str, Any]], device):
        boots = dict(boots or {})
        mems = {}
        for name, m in self.memories.items():
            if name in boots:
                mems[name] = torch.as_tensor(boots.pop(name)).to(
                    device=device, dtype=m.resolved_dtype())
            elif m.boot == "zeros":
                mems[name] = torch.zeros((batch,) + m.shape,
                                         dtype=m.resolved_dtype(),
                                         device=device)
            else:
                raise ValueError(f"memory {name!r} boots extern but no boot "
                                 f"value given")
        if boots:
            raise ValueError(f"unknown boot memories: {sorted(boots)}")
        return mems

    # ---- training path ---------------------------------------------
    def run(self, params, xs, lengths=None, *, boots=None, statics=(),
            reverse: Optional[bool] = None):
        """Unroll over time.

        xs:      one tensor or tuple of tensors, each [B, T, ...] -- the
                 sequence inputs, consumed stepwise.
        lengths: [B] valid lengths (None = full length).
        boots:   dict name -> [B, ...] initial memory values.
        statics: extra non-sequence inputs passed to every step after the
                 sequence inputs.

        Returns (outputs, final_mems): outputs has the step's out tree
        with a time axis at position 1 ([B, T, ...]).
        """
        xs = xs if isinstance(xs, tuple) else (xs,)
        if not xs:
            raise ValueError("run() needs at least one sequence input")
        b, t = xs[0].shape[0], xs[0].shape[1]
        for x in xs:
            if tuple(x.shape[:2]) != (b, t):
                raise ValueError(f"sequence inputs disagree on [B, T]: "
                                 f"{tuple(x.shape[:2])} vs {(b, t)}")
        reverse = self.reverse if reverse is None else reverse
        dev = xs[0].device
        mems = self._boot(b, boots, dev)
        if lengths is None:
            mask = torch.ones((b, t), dtype=torch.bool, device=dev)
        else:
            mask = torch.arange(t, device=dev)[None, :] < \
                lengths.to(dev)[:, None]

        outs = [None] * t
        for i in (reversed(range(t)) if reverse else range(t)):
            out, new_mems = self.step.apply(params, mems,
                                            *(x[:, i] for x in xs), *statics)
            if set(new_mems) != set(self.memories):
                raise ValueError(f"step returned memories {sorted(new_mems)}"
                                 f", declared {sorted(self.memories)}")
            mems = _mask_merge(mask[:, i], new_mems, mems)
            outs[i] = out
        outputs = _stack_time(outs)
        if not self.out_ignore_mask:
            def mask_out(o):
                if not o.is_floating_point():
                    return o
                return o * mask.reshape(mask.shape + (1,) * (o.ndim - 2)).to(
                    o.dtype)
            outputs = tree_map(mask_out, outputs)
        return outputs, mems

    # ---- generation path -------------------------------------------
    def generate(self, params, *, embed_fn: Callable, batch_size: int,
                 vocab_size: int, max_len: int, bos_id: int, eos_id: int,
                 beam_size: int = 1, boots=None, statics=(),
                 length_penalty: float = 0.0,
                 modify_logits_fn: Optional[Callable] = None,
                 greedy: Optional[bool] = None):
        """Sequence generation from the SAME step definition.

        The step's per-timestep sequence input is replaced by
        ``embed_fn(prev_tokens)`` (an embedding of the previously
        generated word), and the step's output must be (or contain as its
        first leaf) logits [B, V].

        beam_size=1 -> greedy; returns (tokens [B, L], lengths [B]).
        Otherwise beam search; returns (tokens [B, K, L], scores [B, K],
        lengths [B, K]). Pass greedy=False to force the beam-shaped
        contract even at beam_size=1. The device is that of the first
        tensor among boots, statics and params.
        """
        found = [x for x in tree_leaves([boots or {}, list(statics), params])
                 if isinstance(x, torch.Tensor)]
        if not found:
            raise ValueError("generate() finds no tensor in boots, statics "
                             "or params to place its state on")
        mems0 = self._boot(batch_size, boots, found[0].device)
        # statics ride in the decoder state so beam_search tiles and
        # re-gathers them consistently with the memories
        carry0 = (mems0, tuple(statics))

        def step_fn(prev_tokens, carry):
            mems, stat = carry
            x_t = embed_fn(prev_tokens)
            out, new_mems = self.step.apply(params, mems, x_t, *stat)
            logits = tree_leaves(out)[0]
            return logits, (new_mems, stat)

        if greedy is None:
            greedy = beam_size == 1
        if greedy:
            if beam_size != 1:
                raise ValueError("greedy decode requires beam_size=1")
            return bs.greedy_search(
                carry0, step_fn, batch_size=batch_size, max_len=max_len,
                bos_id=bos_id, eos_id=eos_id)
        return bs.beam_search(
            carry0, step_fn, batch_size=batch_size, beam_size=beam_size,
            max_len=max_len, bos_id=bos_id, eos_id=eos_id,
            vocab_size=vocab_size, length_penalty=length_penalty,
            modify_logits_fn=modify_logits_fn)


def scan_subsequences(group: RecurrentGroup, params, x, inner_lengths, *,
                      boots=None, statics=()):
    """Run a group over each sub-sequence of a 2-level nested batch.

    x: [B, S_out, S_in, ...] -- outer sequences of inner sequences;
    inner_lengths: [B, S_out]. Returns (outputs [B, S_out, S_in, ...],
    final_mems [B, S_out, ...]): the step applied independently within
    every sub-sequence, booted per sub-sequence from `boots` [B, S_out,
    ...] where given."""
    b, so = x.shape[0], x.shape[1]
    flat = x.reshape((b * so,) + tuple(x.shape[2:]))
    flat_len = inner_lengths.reshape(b * so)
    flat_boots = None
    if boots:
        flat_boots = {k: v.reshape((b * so,) + tuple(v.shape[2:]))
                      for k, v in boots.items()}
    outs, finals = group.run(params, flat, flat_len, boots=flat_boots,
                             statics=statics)
    unflat = lambda o: o.reshape((b, so) + tuple(o.shape[1:]))
    return tree_map(unflat, outs), tree_map(unflat, finals)


class RecurrentGroupLayer(Layer):
    """A RecurrentGroup as a Layer over (x [B, T, F], lengths?), so
    groups compose inside Sequential stacks. The output width is
    `out_features`, or the first declared memory's."""

    def __init__(self, step, memories: Dict[str, Memory], *,
                 out_features: Optional[int] = None, reverse: bool = False,
                 name: Optional[str] = None):
        self.group = RecurrentGroup(step, memories, reverse=reverse)
        self.out_features = out_features
        self.name = name

    def _init(self, rng, spec: ShapeSpec, lengths_spec=None,
              _abstract: bool = False):
        b, t, f = spec.shape
        out_f = self.out_features
        if out_f is None:
            out_f = next(iter(self.group.memories.values())).shape[-1]
        out = ShapeSpec((b, t, out_f), spec.dtype)
        if _abstract:
            return {}, {}, out
        params = self.group.init(rng, ShapeSpec((b, f), spec.dtype), batch=b)
        return params, {}, out

    def _apply(self, params, state, x, lengths=None, *, training: bool,
               rng):
        out, _ = self.group.run(params, x, lengths)
        return out, {}


def lstm_group(in_features: int,
               hidden: int) -> Tuple[FnStep, Dict[str, Memory]]:
    """An LSTM expressed as a recurrent group (the reference's
    topology-equivalence fixture: a recurrent_group-built LSTM against
    the fused layer)."""
    def init_fn(rng, mem_specs, x_specs):
        return rnn_ops.init_lstm_params(rng, in_features, hidden)

    def apply_fn(params, mems, x_t):
        st = rnn_ops.lstm_step(params, x_t,
                               rnn_ops.LSTMState(mems["h"], mems["c"]))
        return st.h, {"h": st.h, "c": st.c}

    memories = {
        "h": Memory(hidden),
        "c": Memory(hidden, dtype=torch.promote_types(
            default_policy().accum_dtype, torch.float32)),
    }
    return FnStep(init_fn, apply_fn), memories


def gru_group(in_features: int,
              hidden: int) -> Tuple[FnStep, Dict[str, Memory]]:
    """A GRU expressed as a recurrent group."""
    def init_fn(rng, mem_specs, x_specs):
        return rnn_ops.init_gru_params(rng, in_features, hidden)

    def apply_fn(params, mems, x_t):
        h = rnn_ops.gru_step(params, x_t, mems["h"])
        return h, {"h": h}

    carry = torch.promote_types(default_policy().accum_dtype, torch.float32)
    return FnStep(init_fn, apply_fn), {"h": Memory(hidden, dtype=carry)}
