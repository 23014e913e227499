"""Decoder-only transformer LM (port of `paddle_tpu.models.transformer`).

Pre-LN blocks, a fused QKV projection, rotary positions, grouped-query
attention. Parameters are a plain nested dict of tensors with the JAX
package's tree and layouts (dense kernels `[in, out]`, applied as
`x @ W`), so `models.weights` carries a JAX checkpoint across as is.

Attention: `attn_impl="auto"` is the flash kernel for CUDA tensors and
the dense path for CPU tensors; "flash" on a CPU tensor runs the flash
plain version; "dense" is the materialized-scores path everywhere. The
flash path is differentiable (`ops.flash_attention`: kernel A forward,
a blockwise PyTorch backward).

Ported here: the config, `init_params`, `_rope` (linear/NTK scaling),
`_dense_attention`, `_expand_kv`, `_attention`, the dense `_ffn`,
`_block_parts`/`_block`/`_forward` (with `remat`: each block under
`torch.utils.checkpoint`)/`apply`, the training surface `loss` and
`score` (plain or `fused_ce_chunk` through
`ops.losses.chunked_lm_head_nll`), `_head`, `_cached_attention` and
greedy `generate` (full attention or a rolling sliding-window cache;
compute-dtype or int8 KV caches; float or weight-only int8 params,
`_int8_step_params`), and the ring-cache convention the serving
engine's ring pools share (`_band_valid`, `_ring_slot_valid`,
`_cached_attention` with a per-row slot vector). MoE blocks raise
NotImplementedError until their slice; so `loss` has no MoE aux term.
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
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import losses as losses_ops
from paddle_tpu_torch.ops import norm as norm_ops
from paddle_tpu_torch.ops.flash_attention import flash_attention
from paddle_tpu_torch.ops.paged_attention import (grouped_masked_attention,
                                                  kv_dequantize, kv_quantize)
from paddle_tpu_torch.serve import quant as _quant


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, field for field, so one set of keyword
    arguments builds both. `remat` checkpoints each block in training;
    `fused_ce_chunk` makes `loss` and `score` apply the LM head in chunks
    of that many positions. The `moe_*` family is carried but raises
    until its slice."""

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
    if cfg.moe_experts > 0:
        raise NotImplementedError("MoE blocks are not ported yet")
    smart = initializers.smart_uniform()
    d, h = cfg.dim, cfg.mlp_ratio * cfg.dim
    qkv_w = (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim

    def ln():
        return {"scale": torch.ones(d), "offset": torch.zeros(d)}

    def block():
        return {
            "ln1": ln(),
            "qkv": {"kernel": smart(rng, (d, qkv_w)),
                    "bias": torch.zeros(qkv_w)},
            "proj": {"kernel": smart(rng, (d, d)), "bias": torch.zeros(d)},
            "ln2": ln(),
            "fc1": {"kernel": smart(rng, (d, h)), "bias": torch.zeros(h)},
            "fc2": {"kernel": smart(rng, (h, d)), "bias": torch.zeros(d)},
        }

    params = {
        "embed": {"table": initializers.normal(0.02)(rng, (cfg.vocab, d))},
        "blocks": [block() for _ in range(cfg.n_layers)],
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


def _ffn(cfg: TransformerConfig, p, y):
    """The block's dense MLP (gelu, tanh approximation as jax.nn.gelu)."""
    if "moe" in p:
        raise NotImplementedError("MoE blocks are not ported yet")
    y = F.gelu(linalg.dense(y, p["fc1"]["kernel"], p["fc1"]["bias"]),
               approximate="tanh")
    return linalg.dense(y, p["fc2"]["kernel"], p["fc2"]["bias"])


def _block_parts(cfg: TransformerConfig, p, x, positions, attn_fn):
    """One pre-LN block with a pluggable attention attn_fn(q, k, v) ->
    [B,T,H,Dh] over compact GQA K/V. Returns (x_out, k, v) with the
    rotated K/V for cache writers."""
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
    return x + _ffn(cfg, p, y), k, v


def _embed(params, tokens):
    x = params["embed"]["table"][tokens.long()]
    return x.to(default_policy().compute_dtype)


def _block(cfg: TransformerConfig, p, x, positions, attn_fn):
    return _block_parts(cfg, p, x, positions, attn_fn)[0]


def _forward(params, cfg: TransformerConfig, tokens, positions=None,
             token_mask=None, attn_fn=None, return_hidden=False):
    """tokens [B,T] int -> logits [B,T,V], or with return_hidden the final
    post-norm hidden [B,T,D] (the losses apply the head themselves).
    attn_fn(q, k, v) overrides the config's attention (K/V expanded to
    q's heads at its door). token_mask is MoE capacity accounting, taken
    for the JAX signature (MoE blocks raise). Under cfg.remat each block
    runs inside torch.utils.checkpoint (non-reentrant) while gradients
    are recorded: only its input is kept, and the backward runs it
    again."""
    x = _embed(params, tokens)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device).expand(tokens.shape)
    if attn_fn is None:
        attn = lambda q, k, v: _attention(cfg, q, k, v, causal=True)
    else:
        attn = lambda q, k, v: attn_fn(q, *_expand_kv(q, k, v))
    remat = cfg.remat and torch.is_grad_enabled()
    for p in params["blocks"]:
        if remat:
            x = checkpoint(_block, cfg, p, x, positions, attn,
                           use_reentrant=False)
        else:
            x = _block(cfg, p, x, positions, attn)
    x = norm_ops.layer_norm(x, params["ln_f"]["scale"],
                            params["ln_f"]["offset"])
    if return_hidden:
        return x
    return linalg.matmul(x, params["lm_head"]["kernel"])


def apply(params, cfg: TransformerConfig, tokens, positions=None):
    """tokens [B,T] int -> logits [B,T,V]."""
    with torch.no_grad():
        return _forward(params, cfg, tokens, positions)


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
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def loss(params, cfg: TransformerConfig, tokens, lengths=None,
         attn_fn=None):
    """Next-token cross entropy, the mean over positions < lengths (all
    positions when lengths is None)."""
    hid = _forward(params, cfg, tokens[:, :-1], attn_fn=attn_fn,
                   return_hidden=True)
    nll = _nll(params, cfg, hid, tokens[:, 1:])
    mask = _target_mask(tokens, lengths)
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)


def score(params, cfg: TransformerConfig, tokens, lengths=None):
    """Per-token next-token log-probabilities [B, T-1] (0 past each row's
    length) and per-sequence mean NLL [B]."""
    hid = _forward(params, cfg, tokens[:, :-1], return_hidden=True)
    gold = -_nll(params, cfg, hid, tokens[:, 1:])
    mask = _target_mask(tokens, lengths)
    if mask is None:
        mask = torch.ones_like(gold, dtype=torch.bool)
    gold = torch.where(mask, gold, 0.0)
    n = torch.clamp(torch.sum(mask, dim=1), min=1)
    return gold, -torch.sum(gold, dim=1) / n


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

    t is a python int (every row writes the same slot: generate's
    lockstep loop) or a [B] tensor of per-row slots (the serving
    engine's ring pool, whose rows are not in lockstep; Tq must be 1).
    A per-row slot outside [0, total) -- the engine's inactive-row
    sentinel -- drops that row's write: torch has no drop-mode scatter,
    so the row rewrites its clipped cell with the value already there,
    and nothing is read back to the host."""
    tq = q.shape[1]
    if isinstance(t, torch.Tensor):
        assert tq == 1, "per-row slot writes need a single-position q"
        total = (k_buf[0] if isinstance(k_buf, tuple) else k_buf).shape[1]
        rows = torch.arange(q.shape[0], device=q.device)
        ts = t.long()
        keep = (ts >= 0) & (ts < total)
        tc = ts.clamp(0, total - 1)

        def write(buf, new):
            new = new[:, 0].to(buf.dtype)
            keep_b = keep.view((-1,) + (1,) * (new.ndim - 1))
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


def generate(params, cfg: TransformerConfig, prompt, steps: int, *,
             eos_id: Optional[int] = None, pad_id: Optional[int] = None,
             prompt_lens=None):
    """Greedy decode with a dense KV cache. prompt [B,T0] int ->
    [B, T0+steps]. eos_id: once a row emits it, later positions are
    pad_id (default eos_id). prompt_lens [B]: right-padded prompts.
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
    params, step_params = _int8_step_params(params)
    with torch.no_grad():
        x = _embed(params, prompt)
        pos = torch.arange(t0, dtype=torch.int32, device=dev).expand(b, t0)
        if prompt_lens is None:
            prefill = lambda q, k, v: _attention(cfg, q, k, v, causal=True)
        else:
            prefill = lambda q, k, v: _attention(
                cfg, q, k, v, causal=True, key_lens=prompt_lens)
        caches = []
        for p in params["blocks"]:
            x, k, v = _block_parts(cfg, p, x, pos, prefill)
            k_buf = torch.zeros((b, cache_len) + tuple(k.shape[2:]),
                                dtype=k.dtype, device=dev)
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
        tok = torch.argmax(at_least_f32(_head(params, x_last)), dim=-1)
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
                x, _, _ = _block_parts(cfg, p, x, pos, attn)
            nxt = torch.argmax(at_least_f32(_head(p_full, x[:, -1])), dim=-1)
            if eos_id is not None:
                done = done | (tok == eos_id)
                nxt = torch.where(done, torch.full_like(nxt, fill), nxt)
            tok = nxt
    toks = torch.stack(out, dim=1).to(prompt.dtype)
    return torch.cat([prompt, toks], dim=1)


def _validate_sampler_args(temperature, top_k, top_p):
    if temperature < 0:
        raise ValueError("temperature must be >= 0")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
