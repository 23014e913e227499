"""Seq2seq NMT with additive attention and beam-search generation (port
of `paddle_tpu.models.seq2seq_attn`).

Bidirectional GRU encoder -> additive (Bahdanau) attention -> GRU
decoder. The encoder's two GRUs run through the fused time loop
(`ops.fused_gru`: kernels F and G on CUDA tensors, their plain versions
on CPU tensors; `impl` picks as in `ops.rnn.gru`). The decoder is a
`RecurrentGroup` of attention plus `gru_step`, unrolled under autograd
for teacher-forced training and driven by `ops.beam_search` for
generation; its attention, GRU step and output projection are torch ops
and `torch.matmul`, as the JAX package leaves them to XLA.

`loss(fused_ce_chunk=...)` applies the hoisted output projection in
chunks of that many positions (`ops.losses.chunked_lm_head_nll`, with
the output bias), so the [B, T, V] logits never exist whole.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.nn.recurrent_group import FnStep, Memory, RecurrentGroup
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import losses
from paddle_tpu_torch.ops import rnn as rnn_ops


def init_params(rng, src_vocab: int, tgt_vocab: int, *, embed_dim: int = 64,
                hidden: int = 64, device=None):
    """The JAX package's tree and distributions. rng: an int seed, a
    numpy RandomState or a CPU torch.Generator (draws differ from
    `jax.random`'s). device None -> cuda (raises without one)."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    smart = initializers.smart_uniform()
    normal = initializers.normal(0.05)
    params = {
        "src_embed": normal(rng, (src_vocab, embed_dim)),
        "tgt_embed": normal(rng, (tgt_vocab, embed_dim)),
        "enc_fwd": rnn_ops.init_gru_params(rng, embed_dim, hidden),
        "enc_bwd": rnn_ops.init_gru_params(rng, embed_dim, hidden),
        # attention: score = v^T tanh(W_h h_dec + W_e h_enc)
        "attn": {
            "w_dec": smart(rng, (hidden, hidden)),
            "w_enc": smart(rng, (2 * hidden, hidden)),
            "v": smart(rng, (hidden, 1)),
        },
        "dec_init": {
            "kernel": smart(rng, (2 * hidden, hidden)),
            "bias": torch.zeros(hidden),
        },
        "dec_gru": rnn_ops.init_gru_params(rng, embed_dim + 2 * hidden,
                                           hidden),
        "out": {
            "kernel": smart(rng, (hidden, tgt_vocab)),
            "bias": torch.zeros(tgt_vocab),
        },
    }
    return tree_map(lambda t: t.to(dev), params)


def _embed(table, tokens):
    return table[tokens.long()]


def _src_mask(src_tokens, src_lengths):
    s = src_tokens.shape[1]
    return torch.arange(s, device=src_tokens.device)[None, :] < \
        src_lengths.to(src_tokens.device)[:, None]


def encode(params, src_tokens, src_lengths, *, impl=None):
    """Returns (enc_out [B, S, 2H], dec_h0 [B, H]); impl selects the
    encoder GRUs' time loop."""
    x = _embed(params["src_embed"], src_tokens)
    enc_out, (h_fwd, h_bwd) = rnn_ops.bidirectional(
        rnn_ops.gru, params["enc_fwd"], params["enc_bwd"], x, src_lengths,
        impl=impl)
    h0 = torch.tanh(linalg.dense(torch.cat([h_fwd, h_bwd], dim=-1),
                                 params["dec_init"]["kernel"],
                                 params["dec_init"]["bias"]))
    return enc_out, h0


def attention_from_proj(params, dec_h, enc_proj, enc_out, enc_mask):
    """Additive attention given the pre-projected encoder states enc_proj
    = enc_out @ w_enc [B, S, H] (computed once per batch, outside the
    decoder loop). dec_h [B, H] -> context [B, 2H]."""
    a = params["attn"]
    proj = torch.tanh(linalg.matmul(dec_h, a["w_dec"])[:, None, :]
                      + enc_proj)                                # [B, S, H]
    scores = linalg.matmul(proj, a["v"])[..., 0]                 # [B, S]
    scores = torch.where(enc_mask, scores, -1e30)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bs,bsf->bf", weights, enc_out.to(weights.dtype))


def project_encoder(params, enc_out):
    """enc_out @ w_enc -- the step-invariant half of the additive score."""
    return linalg.matmul(enc_out, params["attn"]["w_enc"])


def attention(params, dec_h, enc_out, enc_mask):
    """Single-shot attention (projects the encoder bank itself)."""
    return attention_from_proj(params, dec_h, project_encoder(params, enc_out),
                               enc_out, enc_mask)


def _dec_cell(params, mems, x_emb, enc_out, enc_proj, enc_mask):
    """Shared decoder cell: attention + GRU; returns the new hidden."""
    ctx = attention_from_proj(params, mems["h"], enc_proj, enc_out, enc_mask)
    inp = torch.cat([x_emb, ctx.to(x_emb.dtype)], dim=-1)
    return rnn_ops.gru_step(params["dec_gru"], inp, mems["h"])


def _dec_step_apply(params, mems, x_emb, enc_out, enc_proj, enc_mask):
    """Decoder step emitting logits -- the generation-time step."""
    new_h = _dec_cell(params, mems, x_emb, enc_out, enc_proj, enc_mask)
    logits = linalg.dense(new_h, params["out"]["kernel"],
                          params["out"]["bias"])
    return logits, {"h": new_h}


def _dec_hidden_apply(params, mems, x_emb, enc_out, enc_proj, enc_mask):
    """Decoder step emitting the hidden state -- the training-time step
    (the hidden -> vocab projection is hoisted out of the loop)."""
    new_h = _dec_cell(params, mems, x_emb, enc_out, enc_proj, enc_mask)
    return new_h, {"h": new_h}


def decoder_group(hidden: int, *, emit: str = "logits") -> RecurrentGroup:
    """The decoder as a RecurrentGroup. The same cell drives training and
    generation; emit picks the step output ('logits' for generation,
    'hidden' for the hoisted teacher-forced path)."""
    if emit not in ("logits", "hidden"):
        raise ValueError(f"emit must be 'logits' or 'hidden', got {emit!r}")
    step = _dec_step_apply if emit == "logits" else _dec_hidden_apply
    return RecurrentGroup(
        FnStep(lambda rng, mem_specs, x_specs: {}, step),
        {"h": Memory(hidden, boot="extern", dtype=torch.float32)},
        out_ignore_mask=True,
    )


def _encoder_statics(params, src_tokens, src_lengths, impl):
    enc_out, h0 = encode(params, src_tokens, src_lengths, impl=impl)
    statics = (enc_out, project_encoder(params, enc_out),
               _src_mask(src_tokens, src_lengths))
    return h0, statics


def teacher_forced_hidden(params, src_tokens, src_lengths, tgt_in, *,
                          impl=None):
    """Training forward up to the decoder hidden states [B, T, H]."""
    h0, statics = _encoder_statics(params, src_tokens, src_lengths, impl)
    emb = _embed(params["tgt_embed"], tgt_in)                    # [B, T, E]
    hs, _ = decoder_group(h0.shape[-1], emit="hidden").run(
        params, emb, boots={"h": h0}, statics=statics)
    return hs


def teacher_forced_logits(params, src_tokens, src_lengths, tgt_in, *,
                          impl=None):
    """Training forward: tgt_in [B, T] (bos-prefixed targets) -> logits
    [B, T, V]."""
    hs = teacher_forced_hidden(params, src_tokens, src_lengths, tgt_in,
                               impl=impl)
    # hoisted output projection: one [B*T, H] x [H, V] product
    return linalg.dense(hs, params["out"]["kernel"], params["out"]["bias"])


def loss(params, src_tokens, src_lengths, tgt_tokens, tgt_lengths, *,
         bos_id: int = 1, fused_ce_chunk=None, impl=None):
    """Mean per-token CE with teacher forcing. fused_ce_chunk: fold the
    output projection into chunks of that many positions."""
    b, t = tgt_tokens.shape
    bos = torch.full((b, 1), bos_id, dtype=tgt_tokens.dtype,
                     device=tgt_tokens.device)
    tgt_in = torch.cat([bos, tgt_tokens[:, :-1]], dim=1)
    if fused_ce_chunk:
        hs = teacher_forced_hidden(params, src_tokens, src_lengths, tgt_in,
                                   impl=impl)
        ce = losses.chunked_lm_head_nll(
            hs, params["out"]["kernel"], tgt_tokens, chunk=fused_ce_chunk,
            bias=params["out"]["bias"])
    else:
        logits = teacher_forced_logits(params, src_tokens, src_lengths,
                                       tgt_in, impl=impl)
        ce = losses.softmax_cross_entropy(logits, tgt_tokens)      # [B, T]
    mask = (torch.arange(t, device=ce.device)[None, :]
            < tgt_lengths.to(ce.device)[:, None]).to(ce.dtype)
    return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)


def generate(params, src_tokens, src_lengths, *, beam_size: int = 4,
             max_len: int = 20, bos_id: int = 1, eos_id: int = 0,
             length_penalty: float = 0.0, impl=None):
    """Beam-search generation: (tokens [B, K, L], scores [B, K], lengths
    [B, K]), best first."""
    h0, statics = _encoder_statics(params, src_tokens, src_lengths, impl)
    return decoder_group(h0.shape[-1]).generate(
        params,
        embed_fn=lambda toks: _embed(params["tgt_embed"], toks),
        batch_size=src_tokens.shape[0],
        vocab_size=params["out"]["kernel"].shape[1],
        max_len=max_len, bos_id=bos_id, eos_id=eos_id, beam_size=beam_size,
        boots={"h": h0}, statics=statics, length_penalty=length_penalty,
        greedy=False,   # the beam-shaped return contract even at beam 1
    )


def greedy_generate(params, src_tokens, src_lengths, *, max_len: int = 20,
                    bos_id: int = 1, eos_id: int = 0, impl=None):
    """Greedy decode: (tokens [B, L], lengths [B])."""
    h0, statics = _encoder_statics(params, src_tokens, src_lengths, impl)
    return decoder_group(h0.shape[-1]).generate(
        params,
        embed_fn=lambda toks: _embed(params["tgt_embed"], toks),
        batch_size=src_tokens.shape[0],
        vocab_size=params["out"]["kernel"].shape[1],
        max_len=max_len, bos_id=bos_id, eos_id=eos_id, beam_size=1,
        boots={"h": h0}, statics=statics)
