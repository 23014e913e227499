"""Weight-only int8 quantization for serving (port of
`paddle_tpu.serve.quant`).

Decode re-reads every weight matrix once per generated token, so
storing the matmul weights as int8 (+ one f32 scale per output channel)
shrinks them ~4x against f32. Per-channel symmetric absmax: q =
round(w / s) with s = absmax / 127 reduced over the INPUT axis (-2) --
a 2-D `[in, out]` kernel gets one scale per output channel, a stacked
`[E, in, out]` kernel per-stack per-channel scales `[E, out]`. Vectors
(biases, norms) and integer leaves pass through.

The engine and `transformer.generate` keep the int8 tree resident and
dequantize it for each decode step (`transformer._int8_step_params`);
the dequant is plain `q.to(f32) * scale`, the same element sequence as
the JAX package's, so the numbers equal `dequantize_params`.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

import torch

from paddle_tpu_torch.core.pytree import tree_leaves, tree_map, \
    tree_map_with_name


class QuantizedTensor(NamedTuple):
    """int8 values + f32 scales reduced over the input axis (-2):
    shape(scale) = shape(q) with axis -2 removed."""
    q: torch.Tensor       # int8, original shape
    scale: torch.Tensor   # f32


# the matmul kernels; the embedding table is excluded (a gather, not a
# matmul, whose rows feed rope/layernorm where the error compounds)
DEFAULT_MATCH = r"(qkv|proj|fc1|fc2|lm_head|w1|w2|router)"


def quantize_tensor(w) -> QuantizedTensor:
    """Symmetric absmax int8, per output channel per leading stack."""
    wf = w.to(torch.float32)
    absmax = wf.abs().amax(dim=-2)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return QuantizedTensor(q.to(torch.int8), scale.to(torch.float32))


def dequantize_tensor(qt: QuantizedTensor, dtype=torch.float32):
    """q * scale in `dtype`."""
    return (qt.q.to(dtype) * qt.scale[..., None, :].to(dtype)).to(dtype)


def _should_quantize(name: str, leaf, match: Optional[str]) -> bool:
    if not torch.is_tensor(leaf) or leaf.ndim < 2:
        return False
    if not leaf.is_floating_point():
        return False
    return match is None or re.search(match, name) is not None


def quantize_params(params, *, match: Optional[str] = DEFAULT_MATCH):
    """Quantize every matmul-kernel-shaped leaf (ndim >= 2, floating)
    whose path name matches `match` (None: every such leaf). Returns the
    same tree with QuantizedTensor leaves where quantized."""

    def fn(name, leaf):
        if _should_quantize(name, leaf, match):
            return quantize_tensor(leaf)
        return leaf

    return tree_map_with_name(fn, params)


def has_quantized(params) -> bool:
    """True if any leaf is a QuantizedTensor."""
    return any(isinstance(l, QuantizedTensor) for l in tree_leaves(params))


def dequantize_params(qparams, dtype=torch.float32):
    """Inverse of quantize_params: QuantizedTensor leaves dequantize,
    everything else passes through."""
    return tree_map(
        lambda leaf: dequantize_tensor(leaf, dtype)
        if isinstance(leaf, QuantizedTensor) else leaf, qparams)


def quantization_error(params, qparams) -> float:
    """Max relative per-tensor L2 error of the quantized leaves."""
    worst = 0.0
    for p, q in zip(tree_leaves(params), tree_leaves(qparams)):
        if isinstance(q, QuantizedTensor):
            d = dequantize_tensor(q)
            err = float(torch.linalg.norm(d - p.float())
                        / torch.clamp(torch.linalg.norm(p.float()),
                                      min=1e-12))
            worst = max(worst, err)
    return worst
