"""Decoder-only transformer LM (port of `paddle_tpu.models.transformer`).

Pre-LN blocks, a fused QKV projection, rotary positions, grouped-query
attention, and GLaM-style mixture-of-experts blocks (every
`moe_every`-th block's MLP replaced by `moe_experts` experts with top-k
or expert-choice routing, `parallel.moe`). Parameters are a plain nested
dict of tensors with the JAX package's tree and layouts (dense kernels
`[in, out]`, applied as `x @ W`; stacked expert weights `[E, ...]`), so
`models.weights` carries a JAX checkpoint across as is.

Attention: `attn_impl="auto"` is the flash kernel for CUDA tensors and
the dense path for CPU tensors; "flash" on a CPU tensor runs the flash
plain version; "dense" is the materialized-scores path everywhere. The
flash path is differentiable (`ops.flash_attention`: kernel A forward,
a blockwise PyTorch backward).

Training: `loss` and `score` (plain or `fused_ce_chunk` through
`ops.losses.chunked_lm_head_nll`), remat by `torch.utils.checkpoint`
per block; MoE blocks add `moe_aux_weight` times the summed
load-balancing loss, and a `lengths` mask keeps padding out of expert
capacity and the aux.

Decoders, each over dense KV buffers and one `_block_parts` body:
`generate` (greedy or any `select_fn`, e.g. `make_sampler`/`sample`;
right-padded prompts; a rolling sliding-window cache; int8 KV caches;
weight-only int8 params; tensor-parallel DTensor params),
`speculative_generate` and `speculative_sample` (a draft proposes, the
target verifies a window in one forward; per-row position pointers, an
eager loop with one host read per round) and `beam_decode` (over
`ops.beam_search`). The one-shot prefills go through `_attention`
(kernel A on CUDA); the cached steps and windows read full-length
buffers through dense masked einsums, as the JAX package's
`_cached_attention` does.

Parallelism: `TP_RULES`/`TP_MOE_RULES` place the parameters for
`parallel.make_sharded_train_step` (DTensors; kernel A runs on each
rank's batch and head shards through its sharding rule), `generate`
takes such parameters for tensor-parallel decoding, and
`make_context_parallel_loss` runs every attention layer as ring or
Ulysses attention over the `seq` axis.

Randomness: a categorical draw is `argmax(logits + gumbel)`. The
Gumbel draws come from a `torch.Generator` on the logits' device (drawn
once a step) or are injected (`make_sampler(noise=...)`), so a test
can hand the port the draws `jax.random` made.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.dtypes import (at_least_f32, default_policy,
                                          sqrt_in)
from paddle_tpu_torch.core.mesh import (MODEL_AXIS, SEQ_AXIS, P, as_rows,
                                        is_replicated, rows_weight,
                                        split_rows)
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import losses as losses_ops
from paddle_tpu_torch.ops import norm as norm_ops
from paddle_tpu_torch.ops.flash_attention import flash_attention
from paddle_tpu_torch.ops.paged_attention import (grouped_masked_attention,
                                                  kv_dequantize, kv_quantize)
from paddle_tpu_torch.ops import beam_search as bs
from paddle_tpu_torch.ops import sampling as sampling_ops
from paddle_tpu_torch.parallel import moe
from paddle_tpu_torch.parallel.sharding import MEGATRON_RULES
from paddle_tpu_torch.serve import quant as _quant

# tensor-parallel rules for this family: megatron MLP/attention splits
# plus the LM head sharded over the vocab dim
TP_RULES = list(MEGATRON_RULES) + [(r"lm_head/kernel$", P(None, MODEL_AXIS))]

# MoE variant: stacked expert weights sharded over their expert dim
# (axis 0) on the model axis. The router rule must come FIRST: rules
# are first-match and MEGATRON's `out` alternation would otherwise catch
# the substring in "r-out-er" and shard the router's d_model dim (the
# router is replicated by design, as the expert-parallel path keeps it).
TP_MOE_RULES = ([(r"moe/router/kernel$", P())] + TP_RULES +
                [(r"moe/(w1|b1|w2|b2)$", P(MODEL_AXIS))])


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, field for field, so one set of keyword
    arguments builds both. `remat` checkpoints each block in training;
    `fused_ce_chunk` makes `loss` and `score` apply the LM head in chunks
    of that many positions. moe_experts > 0 makes every `moe_every`-th
    block an MoE block (router "topk" with `moe_k` experts a token and
    the aux loss, or "expert_choice")."""

    vocab: int
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    mlp_ratio: int = 4
    rope_base: float = 10000.0
    # "flash" = the flash kernel (its plain version on CPU tensors),
    # "dense" = materialized scores, "auto" = flash on CUDA, dense on CPU
    attn_impl: str = "auto"
    n_kv_heads: Optional[int] = None
    rope_scaling: str = "none"
    rope_factor: float = 1.0
    attn_window: Optional[int] = None
    remat: bool = False
    fused_ce_chunk: Optional[int] = None
    kv_cache_dtype: str = "compute"
    moe_experts: int = 0
    moe_every: int = 2
    moe_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_router: str = "topk"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads if self.n_kv_heads is not None else self.n_heads
        if self.n_heads % kv != 0:
            raise ValueError(
                f"n_kv_heads {kv} must divide n_heads {self.n_heads}")
        return kv

    def is_moe_block(self, i: int) -> bool:
        return self.moe_experts > 0 and i % self.moe_every == (
            self.moe_every - 1)


def init_params(rng, cfg: TransformerConfig, *, device=None):
    """Random parameters with the JAX package's tree, shapes and
    distributions. rng: an int seed, a numpy RandomState or a CPU
    torch.Generator. device None -> cuda (raises without one)."""
    dev = resolve_device(device)
    if isinstance(rng, (int, np.integer)):
        rng = np.random.RandomState(int(rng))
    smart = initializers.smart_uniform()
    d, h = cfg.dim, cfg.mlp_ratio * cfg.dim
    qkv_w = (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim

    def ln():
        return {"scale": torch.ones(d), "offset": torch.zeros(d)}

    def block(i):
        p = {
            "ln1": ln(),
            "qkv": {"kernel": smart(rng, (d, qkv_w)),
                    "bias": torch.zeros(qkv_w)},
            "proj": {"kernel": smart(rng, (d, d)), "bias": torch.zeros(d)},
            "ln2": ln(),
        }
        if cfg.is_moe_block(i):
            p["moe"] = moe.init_moe_params(rng, cfg.moe_experts, d, h,
                                           device="cpu")
        else:
            p["fc1"] = {"kernel": smart(rng, (d, h)), "bias": torch.zeros(h)}
            p["fc2"] = {"kernel": smart(rng, (h, d)), "bias": torch.zeros(d)}
        return p

    params = {
        "embed": {"table": initializers.normal(0.02)(rng, (cfg.vocab, d))},
        "blocks": [block(i) for i in range(cfg.n_layers)],
        "ln_f": ln(),
        "lm_head": {"kernel": smart(rng, (d, cfg.vocab))},
    }
    return tree_map(lambda t: t.to(dev), params)


def _rope(x, positions, base: float, scaling: str = "none",
          factor: float = 1.0):
    """Rotary embedding. x: [B,T,H,Dh] (Dh even), positions: [B,T]."""
    dh = x.shape[-1]
    if scaling not in ("none", "linear", "ntk"):
        raise ValueError(
            f"rope_scaling must be none|linear|ntk, got {scaling!r}")
    if factor <= 0:
        raise ValueError(f"rope_factor must be > 0, got {factor}")
    if scaling == "linear" and factor != 1.0:
        positions = positions / factor
    elif scaling == "ntk" and factor != 1.0:
        base = base * factor ** (dh / max(dh - 2, 1))
    freqs = torch.pow(base, -torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def _dense_attention(q, k, v, causal: bool, key_mask=None, window=None):
    """Exact reference attention; [B,T,H,Dh] in/out, f32 scores.
    key_mask: optional [B, Tk] bool. window: causal band."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / sqrt_in(q.dtype, dh)
    scores = at_least_f32(scores)
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        if window is not None:
            qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
            mask = mask & (qpos - torch.arange(tk, device=q.device)[None, :]
                           < window)
        scores = scores.masked_fill(~mask, -1e30)
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask[:, None, None, :], -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _expand_kv(q, k, v):
    """Broadcast compact GQA K/V ([B,T,Hkv,Dh]) to q's head count."""
    h, hkv = q.shape[2], k.shape[2]
    if hkv == h:
        return k, v
    g = h // hkv
    return (torch.repeat_interleave(k, g, dim=2),
            torch.repeat_interleave(v, g, dim=2))


def _attention(cfg: TransformerConfig, q, k, v, causal: bool,
               key_mask=None, key_lens=None):
    """key_lens [B] describes right-padded rows and rides the flash
    kernel's per-row bound; key_mask [B, Tk] forces the dense path."""
    k, v = _expand_kv(q, k, v)
    if key_mask is not None and key_lens is not None:
        raise ValueError("pass key_mask or key_lens, not both")
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "flash" if q.is_cuda else "dense"
    elif impl not in ("flash", "dense"):
        raise ValueError(f"attn_impl must be auto|flash|dense, got {impl!r}")
    window = cfg.attn_window
    if impl == "flash" and key_mask is None:
        return flash_attention(q, k, v, causal=causal, key_lens=key_lens,
                               window=window)
    if key_mask is None and key_lens is not None:
        key_mask = (torch.arange(k.shape[1], device=q.device)[None, :]
                    < key_lens.to(q.device)[:, None])
    return _dense_attention(q, k, v, causal, key_mask, window)


def _ffn(cfg: TransformerConfig, p, y, token_mask=None):
    """The block's position-wise FFN: the dense MLP (gelu, tanh
    approximation as jax.nn.gelu), or MoE where the block carries expert
    params. Returns (out, aux_loss). token_mask [B, T] keeps padding
    from claiming expert capacity."""
    if "moe" in p:
        b, t, d = y.shape
        flat_mask = None if token_mask is None else token_mask.reshape(b * t)
        if cfg.moe_router == "expert_choice":
            out = moe.expert_choice_ffn(
                p["moe"], y.reshape(b * t, d),
                capacity_factor=cfg.moe_capacity_factor, token_mask=flat_mask)
        elif cfg.moe_router == "topk":
            out = moe.moe_ffn(p["moe"], y.reshape(b * t, d), k=cfg.moe_k,
                              capacity_factor=cfg.moe_capacity_factor,
                              token_mask=flat_mask)
        else:
            raise ValueError(f"moe_router must be 'topk' or 'expert_choice', "
                             f"got {cfg.moe_router!r}")
        return out.y.reshape(b, t, d), out.aux_loss
    y = F.gelu(linalg.dense(y, p["fc1"]["kernel"], p["fc1"]["bias"]),
               approximate="tanh")
    return (linalg.dense(y, p["fc2"]["kernel"], p["fc2"]["bias"]),
            torch.zeros((), device=y.device))


def _block_parts(cfg: TransformerConfig, p, x, positions, attn_fn,
                 token_mask=None):
    """One pre-LN block with a pluggable attention attn_fn(q, k, v) ->
    [B,T,H,Dh] over compact GQA K/V. Returns (x_out, k, v, aux): the
    rotated K/V for cache writers and the block's MoE aux loss (0 for a
    dense block). token_mask [B, T] marks the positions that may claim
    expert capacity."""
    b, t, d = x.shape
    h, hkv, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    y = norm_ops.layer_norm(x, p["ln1"]["scale"], p["ln1"]["offset"])
    qkv = linalg.dense(y, p["qkv"]["kernel"], p["qkv"]["bias"])
    q = qkv[..., :h * dh].reshape(b, t, h, dh)
    k = qkv[..., h * dh:(h + hkv) * dh].reshape(b, t, hkv, dh)
    v = qkv[..., (h + hkv) * dh:].reshape(b, t, hkv, dh)
    q = _rope(q, positions, cfg.rope_base, cfg.rope_scaling, cfg.rope_factor)
    k = _rope(k, positions, cfg.rope_base, cfg.rope_scaling, cfg.rope_factor)
    a = attn_fn(q, k, v).reshape(b, t, d)
    x = x + linalg.dense(a, p["proj"]["kernel"], p["proj"]["bias"])
    y = norm_ops.layer_norm(x, p["ln2"]["scale"], p["ln2"]["offset"])
    out, aux = _ffn(cfg, p, y, token_mask)
    return x + out, k, v, aux


def _embed(params, tokens):
    table = params["embed"]["table"]
    if split_rows(tokens) and is_replicated(table):
        # data parallel: each rank's rows looked up in its copy
        # (`core.mesh.split_rows`)
        x = as_rows(rows_weight(table, tokens)[tokens.to_local().long()],
                    tokens)
    else:
        x = table[tokens.long()]
    return x.to(default_policy().compute_dtype)


def _block(cfg: TransformerConfig, p, x, positions, attn_fn,
           token_mask=None):
    out, _, _, aux = _block_parts(cfg, p, x, positions, attn_fn, token_mask)
    return out, aux


def _forward(params, cfg: TransformerConfig, tokens, positions=None,
             token_mask=None, attn_fn=None, return_hidden=False):
    """tokens [B,T] int -> (logits [B,T,V], summed MoE aux loss), or with
    return_hidden the final post-norm hidden [B,T,D] in place of the
    logits (the losses apply the head themselves). token_mask [B,T] bool
    marks real positions for MoE capacity. attn_fn(q, k, v) overrides
    the config's attention (K/V expanded to q's heads at its door).
    Under cfg.remat each block runs inside torch.utils.checkpoint
    (non-reentrant) while gradients are recorded: only its input is
    kept, and the backward runs it again (the routing repeats: it is a
    function of the block's input)."""
    x = _embed(params, tokens)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device).expand(tokens.shape)
    if attn_fn is None:
        attn = lambda q, k, v: _attention(cfg, q, k, v, causal=True)
    else:
        attn = lambda q, k, v: attn_fn(q, *_expand_kv(q, k, v))
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    for p in params["blocks"]:
        if remat:
            x, a = checkpoint(_block, cfg, p, x, positions, attn, token_mask,
                              use_reentrant=False)
        else:
            x, a = _block(cfg, p, x, positions, attn, token_mask)
        aux = aux + a
    x = norm_ops.layer_norm(x, params["ln_f"]["scale"],
                            params["ln_f"]["offset"])
    if return_hidden:
        return x, aux
    return linalg.matmul(x, params["lm_head"]["kernel"]), aux


def apply(params, cfg: TransformerConfig, tokens, positions=None):
    """tokens [B,T] int -> logits [B,T,V]."""
    with torch.no_grad():
        return _forward(params, cfg, tokens, positions)[0]


def _input_mask(tokens, lengths):
    """[B, T-1] bool: input position i lies inside the row's length (the
    MoE token mask of loss and score); None when lengths is None."""
    if lengths is None:
        return None
    return (torch.arange(tokens.shape[1] - 1, device=tokens.device)[None, :]
            < lengths.to(tokens.device)[:, None])


def _target_mask(tokens, lengths):
    """[B, T-1] bool: target position i (token i+1) lies inside the row's
    length; None when lengths is None."""
    if lengths is None:
        return None
    return (torch.arange(1, tokens.shape[1], device=tokens.device)[None, :]
            < lengths.to(tokens.device)[:, None])


def _nll(params, cfg: TransformerConfig, hidden, targets):
    """Per-position next-token nll [B, T] f32 from the final hidden:
    through chunked_lm_head_nll under cfg.fused_ce_chunk, else logits in
    at least f32, logsumexp minus the gold logit."""
    kernel = params["lm_head"]["kernel"]
    if cfg.fused_ce_chunk:
        return losses_ops.chunked_lm_head_nll(hidden, kernel, targets,
                                              chunk=cfg.fused_ce_chunk)
    logits = at_least_f32(linalg.matmul(hidden, kernel))
    # the gold logit keeps its last dim until the subtraction: a
    # vocab-sharded DTensor's gather is a masked partial sum whose mask
    # has the gather's shape
    gold = torch.gather(logits, -1, targets.long()[..., None])
    return (torch.logsumexp(logits, dim=-1, keepdim=True) - gold)[..., 0]


def loss(params, cfg: TransformerConfig, tokens, lengths=None,
         attn_fn=None):
    """Next-token cross entropy, the mean over positions < lengths (all
    positions when lengths is None), plus moe_aux_weight times the MoE
    load-balancing aux when the config has experts; positions >=
    lengths claim no expert capacity and add nothing to the aux."""
    hid, aux = _forward(params, cfg, tokens[:, :-1],
                        token_mask=_input_mask(tokens, lengths),
                        attn_fn=attn_fn, return_hidden=True)
    nll = _nll(params, cfg, hid, tokens[:, 1:])
    mask = _target_mask(tokens, lengths)
    if mask is None:
        ce = torch.mean(nll)
    else:
        ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    if cfg.moe_experts > 0:
        ce = ce + cfg.moe_aux_weight * aux
    return ce


def score(params, cfg: TransformerConfig, tokens, lengths=None):
    """Per-token next-token log-probabilities [B, T-1] (0 past each row's
    length) and per-sequence mean NLL [B]."""
    hid, _ = _forward(params, cfg, tokens[:, :-1],
                      token_mask=_input_mask(tokens, lengths),
                      return_hidden=True)
    gold = -_nll(params, cfg, hid, tokens[:, 1:])
    mask = _target_mask(tokens, lengths)
    if mask is None:
        mask = torch.ones_like(gold, dtype=torch.bool)
    gold = torch.where(mask, gold, 0.0)
    n = torch.clamp(torch.sum(mask, dim=1), min=1)
    return gold, -torch.sum(gold, dim=1) / n


def make_context_parallel_loss(cfg: TransformerConfig, mesh, *,
                               kind: str = "ring",
                               batch_axis: Optional[str] = None):
    """Context parallelism for the LM: the tokens' positions are split
    over the mesh `seq` axis and every attention layer runs as ring (or
    Ulysses) attention, exact causal attention where no rank ever holds
    the whole sequence's K/V (`parallel.ring_attention`).

    Returns loss_fn(params, tokens, lengths=None), run by every rank of
    the mesh: `loss`'s value and gradients. tokens [B, n*seq_shards + 1]
    and params are full values, the same on every rank (plain tensors or
    replicated DTensors). Each rank takes its block of the input
    positions (and of the rows, over `batch_axis`), runs the stack on it
    at its global positions, and the per-rank nll sums are summed
    (`collectives.all_reduce_sum`); the parameters enter through
    `collectives.pvary`, so each rank's gradient is the whole one. MoE
    blocks route over every token of the batch at once, which a split
    sequence cannot give: a config with experts is refused, as is a
    sliding window (as in JAX)."""
    from paddle_tpu_torch.parallel import collectives as C
    from paddle_tpu_torch.parallel import ring_attention as RA

    if cfg.attn_window is not None:
        raise ValueError(
            "attn_window is not supported under context parallelism: "
            "the ring/Ulysses attention has no sliding-band plumbing, "
            "and silently training full-attention would diverge from "
            "every other (windowed) path")
    if cfg.moe_experts:
        raise ValueError("MoE blocks route over the whole batch's tokens; "
                         "context parallelism splits them over `seq`")
    inner = {"ring": RA.ring_attention,
             "ulysses": RA.ulysses_attention}.get(kind)
    if inner is None:
        raise ValueError(f"unknown kind {kind!r}: expected 'ring' or 'ulysses'")
    axes = (batch_axis, SEQ_AXIS) if batch_axis else (SEQ_AXIS,)

    def attn(q, k, v):
        return inner(q, k, v, axis=SEQ_AXIS, causal=True, mesh=mesh)

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def loss_fn(params, tokens, lengths=None):
        tokens = full(tokens).to(mesh.device)
        b, t = tokens.shape[0], tokens.shape[1] - 1
        n_seq = mesh.shape[SEQ_AXIS]
        if t % n_seq:
            raise ValueError(f"{t} input positions do not split over "
                             f"{n_seq} seq shards")
        c = t // n_seq
        start = mesh.axis_index(SEQ_AXIS) * c
        rows = slice(None)
        if batch_axis:
            nb = mesh.shape[batch_axis]
            rows = slice(mesh.axis_index(batch_axis) * (b // nb),
                         (mesh.axis_index(batch_axis) + 1) * (b // nb))
        p_loc = tree_map(lambda p: C.pvary(full(p), axes, mesh=mesh), params)
        inp = tokens[rows, start:start + c]
        tgt = tokens[rows, start + 1:start + c + 1]
        pos = torch.arange(start, start + c, dtype=torch.int32,
                           device=inp.device).expand(inp.shape)
        in_mask = _input_mask(tokens, lengths)
        hid, _ = _forward(p_loc, cfg, inp, positions=pos,
                          token_mask=None if in_mask is None
                          else in_mask[rows, start:start + c],
                          attn_fn=attn, return_hidden=True)
        nll = _nll(p_loc, cfg, hid, tgt)
        mask = _target_mask(tokens, lengths)
        if mask is None:
            return C.all_reduce_sum(torch.sum(nll) / (b * t), axes,
                                    mesh=mesh)
        mask = mask[rows, start:start + c]
        count = C._raw_all_reduce(torch.sum(mask).float(), mesh, axes)
        return C.all_reduce_sum(torch.sum(nll * mask)
                                / torch.clamp(count, min=1), axes, mesh=mesh)

    return loss_fn


def _int8_step_params(params):
    """(full_params, step_params) for a decode path: full_params is the
    dequantized tree one-shot prefills read, step_params() dequantizes
    the resident int8 tree again for each decode step (the numbers equal
    `serve.quant.dequantize_params`). Identity for float params."""
    if _quant.has_quantized(params):
        return (_quant.dequantize_params(params),
                lambda: _quant.dequantize_params(params))
    return params, lambda: params


def _head(params, x_last):
    """Final LN + LM head over the last dim: [..., D] -> [..., V]."""
    x_last = norm_ops.layer_norm(x_last, params["ln_f"]["scale"],
                                 params["ln_f"]["offset"])
    return linalg.matmul(x_last, params["lm_head"]["kernel"])


def _band_valid(slots, t, window):
    """The sliding-window band over cache slot indices: slot in
    (t - window, t]. One definition for every decode path (uniform
    prompts only -- slot == position there)."""
    return (slots <= t) & (slots > t - window)


def _ring_slot_valid(pos, window: int):
    """The ring-cache convention, shared by generate()'s rolling loop
    and the serving engine's per-row ring pool: position p lives at
    slot p mod window; after the write at `pos`, ring slot s holds
    absolute position pos - ((pos - s) mod window), valid iff it
    exists. pos is a python int (lockstep loop) or an [S] tensor (the
    per-row pool). Returns (write_slot like pos, valid [..., window])."""
    if isinstance(pos, torch.Tensor):
        p = pos.long()
        arw = torch.arange(window, device=pos.device)
        held = p[..., None] - torch.remainder(p[..., None] - arw, window)
        return torch.remainder(p, window), held >= 0
    arw = torch.arange(window)
    held = pos - torch.remainder(pos - arw, window)
    return pos % window, held >= 0


def _cached_attention(q, k, v, k_buf, v_buf, t, valid):
    """The decode attention over a dense [B, total, Hkv, Dh] cache:
    write this step's K/V at slots t..t+Tq-1 (in place), attend over
    `valid` keys ([..., total] bool broadcastable over [B, H, Tq,
    total]). k_buf/v_buf may be (s8 data, scale) pairs: the new K/V are
    quantized before the write and the whole buffer is dequantized to
    q's dtype for the read. Returns (out, k_buf, v_buf).

    t is a python int (every row writes the same slots: generate's and
    beam_decode's lockstep loops) or a [B] tensor of per-row first slots
    (the serving engine's ring pool; the speculative decoders' windows,
    whose rows are not in lockstep). A per-row slot outside [0, total)
    -- the engine's inactive-row sentinel, a finished speculative row --
    drops that write: torch has no drop-mode scatter, so the row
    rewrites its clipped cell with the value already there, and nothing
    is read back to the host."""
    tq = q.shape[1]
    if isinstance(t, torch.Tensor):
        total = (k_buf[0] if isinstance(k_buf, tuple) else k_buf).shape[1]
        rows = torch.arange(q.shape[0], device=q.device)[:, None]
        ts = t.long()[:, None] + torch.arange(tq, device=q.device)[None, :]
        keep = (ts >= 0) & (ts < total)
        tc = ts.clamp(0, total - 1)

        def write(buf, new):
            new = new.to(buf.dtype)
            keep_b = keep.view(keep.shape + (1,) * (new.ndim - 2))
            buf[rows, tc] = torch.where(keep_b, new, buf[rows, tc])
    else:
        def write(buf, new):
            buf[:, t:t + tq] = new.to(buf.dtype)

    if isinstance(k_buf, tuple):
        for buf, new in ((k_buf, k), (v_buf, v)):
            nd, nsc = kv_quantize(new)
            write(buf[0], nd)
            write(buf[1], nsc)
        k_read = kv_dequantize(*k_buf, q.dtype)
        v_read = kv_dequantize(*v_buf, q.dtype)
    else:
        write(k_buf, k)
        write(v_buf, v)
        k_read, v_read = k_buf, v_buf
    return grouped_masked_attention(q, k_read, v_read, valid), k_buf, v_buf


def _plain_replicated(params):
    """For DTensor (tensor-parallel) parameters, the context in which
    the plain tensors a decoder makes (positions, masks, the prompt)
    count as replicated; else nothing."""
    import contextlib

    leaf = next(iter(tree_leaves(params)), None)
    if hasattr(leaf, "to_local"):
        from torch.distributed.tensor.experimental import \
            implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def _cache_like(k, length: int):
    """Zeros [B, length, Hkv, Dh] in k's dtype and device; for a
    DTensor k (tensor-parallel parameters) a DTensor placed as k is, so
    the cache's writes and reads stay on each rank's shards."""
    shape = (k.shape[0], length) + tuple(k.shape[2:])
    if not hasattr(k, "to_local"):
        return torch.zeros(shape, dtype=k.dtype, device=k.device)
    from torch.distributed.tensor import DTensor

    local = k.to_local()
    buf = torch.zeros((local.shape[0], length) + tuple(local.shape[2:]),
                      dtype=local.dtype, device=local.device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(buf, k.device_mesh, k.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _argmax(logits, rng=None):
    """The greedy selector: the first maximum of the logits in at least
    f32 (jnp.argmax's tie rule)."""
    return torch.argmax(at_least_f32(logits), dim=-1)


def generate(params, cfg: TransformerConfig, prompt, steps: int, *,
             select_fn=None, rng=None, eos_id: Optional[int] = None,
             pad_id: Optional[int] = None, prompt_lens=None):
    """Decode with a dense KV cache. prompt [B,T0] int -> [B, T0+steps].

    select_fn(logits [B, V], rng) -> [B] chooses each next token
    (default: argmax); `make_sampler` builds temperature/top-k/top-p
    selectors. rng: a torch.Generator on the prompt's device, handed to
    select_fn at every step, which draws from it once (default: a
    generator seeded 0). eos_id: once a row emits it, later positions
    are pad_id (default eos_id). prompt_lens [B]: right-padded prompts
    (pad keys masked out, rope positions continuing from each row's own
    length, pads claiming no MoE capacity in the prefill).
    cfg.attn_window below T0+steps decodes over a rolling cache of
    `window` slots (the ring convention). kv_cache_dtype "int8"
    quantizes the prefilled caches once and each step's K/V as it is
    written. Weight-only int8 params (serve.quant) prefill from their
    dequantized tree and dequantize again per step."""
    b, t0 = prompt.shape
    if cfg.kv_cache_dtype not in ("compute", "int8"):
        raise ValueError(f"kv_cache_dtype must be compute|int8, got "
                         f"{cfg.kv_cache_dtype!r}")
    total = t0 + steps
    window = cfg.attn_window
    # sliding-window decode keeps a ROLLING cache of `window` slots,
    # written at t mod window (the ring convention, _ring_slot_valid):
    # per-step cache reads are O(window), not O(t0 + steps); attention
    # order over slots does not matter and rope rode in with K
    rolling = window is not None and window < total
    cache_len = window if rolling else total
    if window is not None and prompt_lens is not None:
        raise ValueError("attn_window with variable-length prompts is "
                         "unsupported")
    fill = eos_id if pad_id is None else pad_id
    dev = prompt.device
    if select_fn is None:
        select_fn = _argmax
    elif rng is None:
        rng = torch.Generator(device=dev)
        rng.manual_seed(0)
    params, step_params = _int8_step_params(params)
    with torch.no_grad(), _plain_replicated(params):
        x = _embed(params, prompt)
        pos = torch.arange(t0, dtype=torch.int32, device=dev).expand(b, t0)
        if prompt_lens is None:
            key_ok = None
            prefill = lambda q, k, v: _attention(cfg, q, k, v, causal=True)
        else:
            # key_ok feeds the MoE token mask; attention takes the lens
            key_ok = (torch.arange(t0, device=dev)[None, :]
                      < prompt_lens.to(dev)[:, None])
            prefill = lambda q, k, v: _attention(
                cfg, q, k, v, causal=True, key_lens=prompt_lens)
        caches = []
        for p in params["blocks"]:
            x, k, v, _ = _block_parts(cfg, p, x, pos, prefill, key_ok)
            k_buf = _cache_like(k, cache_len)
            v_buf = torch.zeros_like(k_buf)
            if rolling:
                # the last `window` prompt positions, each at its ring
                # slot p mod window
                lo = max(0, t0 - cache_len)
                ring = torch.arange(lo, t0, device=dev) % cache_len
                k_buf[:, ring] = k[:, lo:t0]
                v_buf[:, ring] = v[:, lo:t0]
            else:
                k_buf[:, :t0] = k
                v_buf[:, :t0] = v
            if cfg.kv_cache_dtype == "int8":
                # the whole buffer once (zero slots quantize to 0)
                k_buf, v_buf = kv_quantize(k_buf), kv_quantize(v_buf)
            caches.append((k_buf, v_buf))
        if prompt_lens is None:
            x_last = x[:, -1]
        else:
            x_last = x[torch.arange(b, device=dev), prompt_lens.long() - 1]
        tok = select_fn(_head(params, x_last), rng).long()
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        ar = torch.arange(total, device=dev)
        out = []
        for s in range(steps):
            t = t0 + s
            out.append(tok)
            if s == steps - 1:
                break
            p_full = step_params()
            x = _embed(p_full, tok[:, None])
            slot = t
            if prompt_lens is None:
                pos = torch.full((b, 1), t, dtype=torch.int32, device=dev)
                if rolling:
                    # the band holds by construction: valid is "the
                    # position exists"
                    slot, ring_ok = _ring_slot_valid(t, cache_len)
                    valid = ring_ok.to(dev)
                else:
                    valid = ar <= t
                    if window is not None:
                        valid = _band_valid(ar, t, window)
                valid = valid[None, None, None, :]
            else:
                pos = (prompt_lens.to(torch.int32) + s)[:, None]
                valid = ((ar[None, :] < prompt_lens.to(dev)[:, None])
                         | ((ar[None, :] >= t0) & (ar[None, :] <= t)))
                valid = valid[:, None, None, :]
            for p, (k_buf, v_buf) in zip(p_full["blocks"], caches):
                attn = lambda q, k, v, kb=k_buf, vb=v_buf: _cached_attention(
                    q, k, v, kb, vb, slot, valid)[0]
                x, _, _, _ = _block_parts(cfg, p, x, pos, attn)
            nxt = select_fn(_head(p_full, x[:, -1]), rng).long()
            if eos_id is not None:
                done = done | (tok == eos_id)
                nxt = torch.where(done, torch.full_like(nxt, fill), nxt)
            tok = nxt
    toks = torch.stack(out, dim=1).to(prompt.dtype)
    return torch.cat([prompt, toks], dim=1)


_FP_WINDOW = ("kv_cache_dtype='int8' covers generate()/sample() and the "
              "serving engine's slot pool only: the beam/speculative window "
              "path reads fp buffers; decode with generate or DecodeEngine, "
              "or clear kv_cache_dtype")


def _prefill_kv(params, cfg: TransformerConfig, toks, total: int):
    """Run toks [B, W] through the stack with plain causal attention
    (kernel A on CUDA under attn_impl "auto") and return per-block
    `total`-slot K/V buffers filled at [:, :W] -- the shared prefill of
    the speculative and beam decoders."""
    b, w = toks.shape
    x = _embed(params, toks)
    pos = torch.arange(w, dtype=torch.int32, device=toks.device).expand(b, w)
    attn = lambda q, k, v: _attention(cfg, q, k, v, causal=True)
    caches = []
    for blk in params["blocks"]:
        x, k, v, _ = _block_parts(cfg, blk, x, pos, attn)
        bufs = []
        for new in (k, v):
            buf = torch.zeros((b, total) + tuple(new.shape[2:]),
                              dtype=new.dtype, device=toks.device)
            buf[:, :w] = new
            bufs.append(buf)
        caches.append(tuple(bufs))
    return caches


def _window_forward(p, c: TransformerConfig, caches, toks, start, total,
                    write_start=None):
    """Process toks [B, W] at per-row positions start..start+W-1 (start
    a [B] tensor) through the cached stack: window position j of row b
    writes its K/V at slot write_start[b] + j (default start; a slot
    outside the buffer drops the write) and sees the slots <= start[b] +
    j (within the sliding band when configured). Returns logits [B, W,
    V]; the caches are written in place. JAX runs this under vmap, one
    row at a time: MoE blocks route each row's W tokens on their own, so
    a config with experts runs row by row here."""
    b, w = toks.shape
    ws = start if write_start is None else write_start
    if b > 1 and any("moe" in blk for blk in p["blocks"]):
        return torch.cat([_window_forward(
            p, c, [(kb[i:i + 1], vb[i:i + 1]) for kb, vb in caches],
            toks[i:i + 1], start[i:i + 1], total, ws[i:i + 1])
            for i in range(b)])
    dev = toks.device
    x = _embed(p, toks)
    pos = start.long()[:, None] + torch.arange(w, device=dev)[None, :]
    slots = torch.arange(total, device=dev)[None, None, :]
    qpos = pos[:, :, None]
    if c.attn_window is not None:
        valid = _band_valid(slots, qpos, c.attn_window)
    else:
        valid = slots <= qpos
    valid = valid[:, None]                             # [B, 1, W, total]
    pos = pos.to(torch.int32)
    for blk, (k_buf, v_buf) in zip(p["blocks"], caches):
        attn = lambda q, k, v, kb=k_buf, vb=v_buf: _cached_attention(
            q, k, v, kb, vb, ws, valid)[0]
        x, _, _, _ = _block_parts(c, blk, x, pos, attn)
    return _head(p, x)


def _speculative_round_end(out, t, done, rounds, active, app, n_acc,
                           eos_id):
    """Shared tail of a speculative round (in place): append app [B,
    K+1] at each active row's pointer, advance past the accepted tokens
    (or past the first eos among them) and count the round."""
    b, k1 = app.shape
    dev = app.device
    karange = torch.arange(k1, device=dev)[None, :]
    if eos_id is not None:
        hit = (app == eos_id) & (karange <= n_acc[:, None])
        found = hit.any(dim=1)
        adv = torch.where(found, torch.argmax(hit.to(torch.int32), dim=1) + 1,
                          n_acc + 1)
    else:
        found = torch.zeros_like(done)
        adv = n_acc + 1
    rows = torch.arange(b, device=dev)[:, None]
    cols = (t[:, None] + karange).clamp(max=out.shape[1] - 1)
    out[rows, cols] = torch.where(active[:, None], app.to(out.dtype),
                                  out[rows, cols])
    t.copy_(torch.where(active, t + adv, t))
    done |= active & found
    rounds += active.to(rounds.dtype)


def _speculative_setup(cfg, draft_cfg, prompt, steps, draft_k):
    """Checks, then (total slots, the output buffer holding the prompt,
    per-row pointers, done flags, round counts)."""
    if cfg.kv_cache_dtype != "compute" or \
            draft_cfg.kv_cache_dtype != "compute":
        raise ValueError(_FP_WINDOW)
    b, t0 = prompt.shape
    if t0 < 2:
        raise ValueError("need a >=2-token prompt (prefill t0-1, then the "
                         "last token seeds the first round)")
    total = t0 + steps + draft_k + 1   # the last round may overshoot
    dev = prompt.device
    out = torch.zeros((b, total), dtype=prompt.dtype, device=dev)
    out[:, :t0] = prompt
    t = torch.full((b,), t0, dtype=torch.long, device=dev)
    return (total, out, t, torch.zeros(b, dtype=torch.bool, device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev))


def _speculative_finish(out, t, done, rounds, eos_id, pad_id, t_end,
                        return_stats):
    if eos_id is not None:
        # a finished row's positions from its stop point on are fill, as
        # generate() pads after eos
        fill = eos_id if pad_id is None else pad_id
        col = torch.arange(out.shape[1], device=out.device)[None, :]
        out = torch.where(done[:, None] & (col >= t[:, None]),
                          torch.full_like(out, fill), out)
    if return_stats:
        return out[:, :t_end], rounds
    return out[:, :t_end]


def speculative_generate(params, cfg: TransformerConfig,
                         draft_params, draft_cfg: TransformerConfig,
                         prompt, steps: int, *, draft_k: int = 4,
                         eos_id: Optional[int] = None,
                         pad_id: Optional[int] = None,
                         return_stats: bool = False):
    """Greedy speculative decoding: the draft proposes `draft_k` tokens
    autoregressively, the target scores them in ONE (K+1)-position
    window forward, and the longest agreeing prefix is accepted plus the
    target's own token at the first disagreement. The output is exactly
    the target's greedy decode; a bad draft costs speed only.

    Rows accept different prefix lengths, so each row keeps its own
    position pointer; a finished row replays rounds with its pointer,
    output and round count frozen (its writes are dropped). The loop is
    eager, with one host read a round (any row still active). Cache
    slots are indexed by position, so rejected writes are overwritten
    when the real token reaches them. eos_id: a row that emits it stops;
    its later positions are pad_id (default eos_id), as in generate().
    return_stats=True also returns the per-row round counts [B]
    (int32)."""
    total, out, t, done, rounds = _speculative_setup(
        cfg, draft_cfg, prompt, steps, draft_k)
    t_end = prompt.shape[1] + steps
    params, tgt_step_params = _int8_step_params(params)
    draft_params, dft_step_params = _int8_step_params(draft_params)
    rows = torch.arange(prompt.shape[0], device=prompt.device)
    two = torch.arange(2, device=prompt.device)[None, :]
    with torch.no_grad():
        # slots 0..t0-2; token t0-1 seeds the first round's windows
        tgt_c = _prefill_kv(params, cfg, prompt[:, :-1], total)
        dft_c = _prefill_kv(draft_params, draft_cfg, prompt[:, :-1], total)
        while True:
            active = ~done & (t < t_end)
            if not bool(active.any()):
                break
            tgt_p, dft_p = tgt_step_params(), dft_step_params()
            frozen = lambda start: torch.where(active, start, total)
            # the draft re-processes positions t-2 and t-1: after a fully
            # accepted round it never saw its own last accepted token
            last2 = out[rows[:, None], t[:, None] - 2 + two]
            logits = _window_forward(dft_p, draft_cfg, dft_c, last2, t - 2,
                                     total, frozen(t - 2))
            tok = _argmax(logits[:, -1])
            drafts = [tok]
            for i in range(draft_k - 1):
                logits = _window_forward(dft_p, draft_cfg, dft_c,
                                         tok[:, None], t + i, total,
                                         frozen(t + i))
                tok = _argmax(logits[:, -1])
                drafts.append(tok)
            drafts = torch.stack(drafts, dim=1)                 # [B, K]
            window = torch.cat([out[rows, t - 1][:, None],
                                drafts.to(out.dtype)], dim=1)   # [B, K+1]
            logits = _window_forward(tgt_p, cfg, tgt_c, window, t - 1,
                                     total, frozen(t - 1))
            greedy = _argmax(logits)                            # [B, K+1]
            n_acc = sampling_ops._first_false(drafts == greedy[:, :draft_k])
            karange = torch.arange(draft_k + 1, device=out.device)[None, :]
            app = torch.where(karange < n_acc[:, None],
                              torch.cat([drafts, greedy[:, -1:]], dim=1),
                              greedy)
            _speculative_round_end(out, t, done, rounds, active, app, n_acc,
                                   eos_id)
    return _speculative_finish(out, t, done, rounds, eos_id, pad_id, t_end,
                               return_stats)


def speculative_sample(params, cfg: TransformerConfig,
                       draft_params, draft_cfg: TransformerConfig,
                       prompt, steps: int, rng=None, *, draft_k: int = 4,
                       temperature: float = 1.0,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None,
                       eos_id: Optional[int] = None,
                       pad_id: Optional[int] = None,
                       return_stats: bool = False):
    """Sampled speculative decoding by modified rejection (Leviathan et
    al.; Chen et al. 2023): the draft samples draft_k tokens from its
    filtered distribution q, the target scores the window in one
    forward, draft x_i is accepted with probability min(1, p_i(x_i) /
    q_i(x_i)), and the round's last token is drawn from the residual
    max(p_i - q_i, 0) at the first rejection (from the target's next
    distribution after a full acceptance). The tokens are distributed as
    token-by-token sampling from the target under the same
    temperature/top-k/top-p filter; at top_k=1 this is greedy.

    rng: a torch.Generator on the prompt's device (default: seeded 0):
    each round draws the draft's Gumbel noise, the acceptance uniforms
    and the final token's noise from it. Pointers, eos/pad and
    return_stats as in speculative_generate. temperature must be > 0."""
    total, out, t, done, rounds = _speculative_setup(
        cfg, draft_cfg, prompt, steps, draft_k)
    if temperature <= 0:
        raise ValueError("temperature must be > 0 (speculative_generate is "
                         "the greedy decoder)")
    _validate_sampler_args(temperature, top_k, top_p)
    b, t0 = prompt.shape
    t_end = t0 + steps
    dev = prompt.device
    if rng is None:
        rng = torch.Generator(device=dev)
        rng.manual_seed(0)
    params, tgt_step_params = _int8_step_params(params)
    draft_params, dft_step_params = _int8_step_params(draft_params)
    rows = torch.arange(b, device=dev)
    two = torch.arange(2, device=dev)[None, :]
    v = cfg.vocab

    def filt_logp(logits):
        """The filtered log-distribution [..., V] both models sample and
        score under, so acceptance preserves it."""
        flat = logits.reshape(-1, logits.shape[-1])
        return torch.log_softmax(_filter_logits(
            at_least_f32(flat), temperature, top_k, top_p),
            dim=-1).reshape(logits.shape[:-1] + (flat.shape[-1],))

    def draw(logp):
        return categorical(logp, sampling_ops.gumbel_noise(
            logp.shape, generator=rng, device=dev))

    with torch.no_grad():
        tgt_c = _prefill_kv(params, cfg, prompt[:, :-1], total)
        dft_c = _prefill_kv(draft_params, draft_cfg, prompt[:, :-1], total)
        while True:
            active = ~done & (t < t_end)
            if not bool(active.any()):
                break
            tgt_p, dft_p = tgt_step_params(), dft_step_params()
            frozen = lambda start: torch.where(active, start, total)
            last2 = out[rows[:, None], t[:, None] - 2 + two]
            logits = _window_forward(dft_p, draft_cfg, dft_c, last2, t - 2,
                                     total, frozen(t - 2))
            q = filt_logp(logits[:, -1])                        # [B, V]
            tok = draw(q)
            drafts, qs = [tok], [q]
            for i in range(draft_k - 1):
                logits = _window_forward(dft_p, draft_cfg, dft_c,
                                         tok[:, None], t + i, total,
                                         frozen(t + i))
                q = filt_logp(logits[:, -1])
                tok = draw(q)
                drafts.append(tok)
                qs.append(q)
            drafts = torch.stack(drafts, dim=1)                 # [B, K]
            qdist = torch.stack(qs, dim=1)                      # [B, K, V]
            window = torch.cat([out[rows, t - 1][:, None],
                                drafts.to(out.dtype)], dim=1)
            logits = _window_forward(tgt_p, cfg, tgt_c, window, t - 1,
                                     total, frozen(t - 1))
            pdist = filt_logp(logits)                           # [B, K+1, V]
            # modified rejection: accept x_i w.p. min(1, p_i / q_i)
            p_x = torch.gather(pdist[:, :draft_k], 2, drafts[:, :, None])[
                ..., 0]
            q_x = torch.gather(qdist, 2, drafts[:, :, None])[..., 0]
            u = torch.rand((b, draft_k), generator=rng, device=dev)
            n_acc = sampling_ops._first_false(u < torch.exp(torch.clamp(p_x - q_x,
                                                           max=0.0)))
            # the last token: the residual (p - q)+ at the rejection, or
            # the target's next distribution when every draft holds
            n_sel = torch.clamp(n_acc, max=draft_k - 1)
            p_rej = torch.exp(pdist[rows, n_sel])
            res = torch.clamp(p_rej - torch.exp(qdist[rows, n_sel]), min=0.0)
            # residual mass rounding to zero means p == q: draw from p
            res = torch.where(res.sum(dim=-1, keepdim=True) > 0, res, p_rej)
            g = sampling_ops.gumbel_noise((b, v), generator=rng, device=dev)
            tok_rej = categorical(torch.log(res + 1e-38), g)
            tok_all = categorical(pdist[:, draft_k], g)
            resolved = torch.where(n_acc < draft_k, tok_rej, tok_all)
            karange = torch.arange(draft_k + 1, device=dev)[None, :]
            app = torch.where(karange < n_acc[:, None],
                              torch.cat([drafts, resolved[:, None]], dim=1),
                              resolved[:, None])
            _speculative_round_end(out, t, done, rounds, active, app, n_acc,
                                   eos_id)
    return _speculative_finish(out, t, done, rounds, eos_id, pad_id, t_end,
                               return_stats)


def beam_decode(params, cfg: TransformerConfig, prompt, steps: int,
                beam_size: int = 4, *, eos_id: Optional[int] = None,
                length_penalty: float = 0.0):
    """Beam-search decode over the KV cache (ops.beam_search's loop over
    the transformer's cached step). prompt [B, T0] (uniform length) ->
    (sequences [B, K, T0+steps], scores [B, K]) best-first; without an
    eos_id every beam runs the full `steps`. Weight-only int8 params are
    dequantized for the prefill and again in every step."""
    if cfg.kv_cache_dtype != "compute":
        raise ValueError(_FP_WINDOW)
    b, t0 = prompt.shape
    total = t0 + steps
    dev = prompt.device
    params, step_params = _int8_step_params(params)
    with torch.no_grad():
        # prefill all but the last prompt token; beam_search feeds that
        # token as each row's first input (bos_tokens)
        caches = {}
        if t0 > 1:
            kvs = _prefill_kv(params, cfg, prompt[:, :-1], total)
        else:
            # nothing to prefill: empty buffers in the dtype each block's
            # K/V come out in (one position through the stack tells)
            kvs, x = [], _embed(params, prompt[:1])
            pos = torch.zeros((1, 1), dtype=torch.int32, device=dev)
            for blk in params["blocks"]:
                x, k, _, _ = _block_parts(cfg, blk, x, pos,
                                          lambda q, k, v: q)
                kvs.append(tuple(torch.zeros((b, total) + tuple(k.shape[2:]),
                                             dtype=k.dtype, device=dev)
                                 for _ in range(2)))
        for i, (k_buf, v_buf) in enumerate(kvs):
            caches[f"k{i}"] = k_buf
            caches[f"v{i}"] = v_buf
        slot = [t0 - 1]              # the slot of each step's input token
        ar = torch.arange(total, device=dev)

        def step_fn(toks, dec):
            p_full = step_params()
            t = slot[0]
            slot[0] += 1
            x = _embed(p_full, toks[:, None])
            pos = torch.full((toks.shape[0], 1), t, dtype=torch.int32,
                             device=dev)
            if cfg.attn_window is not None:
                valid = _band_valid(ar, t, cfg.attn_window)
            else:
                valid = ar <= t
            valid = valid[None, None, None, :]
            for i, blk in enumerate(p_full["blocks"]):
                attn = lambda q, k, v, kb=dec[f"k{i}"], vb=dec[f"v{i}"]: \
                    _cached_attention(q, k, v, kb, vb, t, valid)[0]
                x, _, _, _ = _block_parts(cfg, blk, x, pos, attn)
            return _head(p_full, x[:, -1]), dec

        toks, scores, _ = bs.beam_search(
            caches, step_fn, batch_size=b, beam_size=beam_size,
            max_len=steps, bos_id=0,
            eos_id=-1 if eos_id is None else eos_id, vocab_size=cfg.vocab,
            length_penalty=length_penalty, bos_tokens=prompt[:, -1])
    seqs = torch.cat([prompt[:, None, :].expand(b, beam_size, t0),
                      toks.to(prompt.dtype)], dim=-1)
    return seqs, scores


def _validate_sampler_args(temperature, top_k, top_p):
    if temperature < 0:
        raise ValueError("temperature must be >= 0")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _filter_logits(logits, temperature, top_k, top_p):
    """Temperature scaling, then optional top-k truncation (ties at the
    k-th logit all survive), then optional nucleus filtering over the
    top-k-filtered distribution, on [N, V] logits; filtered-out tokens
    become -inf. temperature > 0. The filters are ops.sampling's per-row
    ones with every row's parameters equal; an absent top_p is an
    infinite one (per_row_filter_logits's 1.0 would still drop a tail
    whose cumulative mass rounds to 1)."""
    if top_k is None and top_p is None:
        return logits / temperature
    n, v = logits.shape
    full = lambda value, dtype: torch.full((n,), value, dtype=dtype,
                                           device=logits.device)
    return sampling_ops.per_row_filter_logits(
        logits, full(temperature, torch.float32),
        full(v if top_k is None else min(top_k, v), torch.int64),
        full(float("inf") if top_p is None else top_p, torch.float32))


def categorical(logits, noise):
    """The Gumbel-max draw: argmax(logits + noise) over the last dim,
    with noise standard Gumbel draws of logits' shape (jax.random's
    categorical adds its own gumbel draws the same way)."""
    return torch.argmax(logits + noise.to(logits.dtype), dim=-1)


def make_sampler(*, temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, noise=None):
    """Build a select_fn for `generate`: temperature scaling, then
    optional top-k truncation, then optional nucleus (top-p) filtering,
    then a categorical draw; temperature 0 is argmax. top_k is clamped
    to the vocab, and ties at the k-th logit all survive.

    The draw's Gumbel noise comes from the rng generate hands over (one
    [B, V] draw a step), or from noise(shape) -> Tensor when given: a
    test feeds the draws jax.random made."""
    _validate_sampler_args(temperature, top_k, top_p)

    def select(logits, rng):
        logits = at_least_f32(logits)
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        filtered = _filter_logits(logits, temperature, top_k, top_p)
        g = (noise(filtered.shape) if noise is not None else
             sampling_ops.gumbel_noise(filtered.shape, generator=rng,
                                       device=filtered.device))
        return categorical(filtered, g)

    return select


def sample(params, cfg: TransformerConfig, prompt, steps: int, rng=None, *,
           temperature: float = 1.0, top_k: Optional[int] = None,
           top_p: Optional[float] = None, eos_id: Optional[int] = None,
           pad_id: Optional[int] = None, prompt_lens=None, noise=None):
    """Sampled decode: generate() with make_sampler's selector and the
    rng (a torch.Generator on the prompt's device); eos/pad and
    variable-length prompts as generate()."""
    return generate(params, cfg, prompt, steps,
                    select_fn=make_sampler(temperature=temperature,
                                           top_k=top_k, top_p=top_p,
                                           noise=noise),
                    rng=rng, eos_id=eos_id, pad_id=pad_id,
                    prompt_lens=prompt_lens)
