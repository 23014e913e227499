"""Continuous-batching decode engine over a block-paged KV pool (port of
`paddle_tpu.serve.engine`, the paged path).

A fixed pool of S decode slots with static shapes: per layer one
`[num_pages, page_size, Hkv, Dh]` K and V arena plus a `[S,
max_pages_per_slot]` int32 page table. Pages are allocated and freed on
the host (`serve.paged.PagePool`) at admission, at page boundaries and
at retirement; the host loop admits a queued request the moment a slot
frees (continuous batching). Shared prompt prefixes map to refcounted
read-only pages, and prefill starts at the first private position.

The device work of a step is eager PyTorch around two kernels:

- a prompt's first prefill chunk (`from_zero`) runs causal attention
  within the chunk -- `transformer._attention`, which is the flash
  kernel on CUDA under `attn_impl="auto"`;
- every cached read -- each decode step (TQ=1), each later or
  prefix-hit prefill chunk (TQ=C) and each speculative verify window
  (TQ=K+1) -- goes through the ragged page-table walk
  (`ops.ragged_paged_attention`), chosen by `ragged_impl`:
  None = the kernel on CUDA tensors (the plain version on CPU),
  "torch" = the plain version, "kernel" = the kernel (raises on CPU).

int8 serving, two independent levers:

- `kv_cache_dtype="int8"` holds every arena as an (s8 data, f32 scale)
  pair: half the bytes of a bf16 pool, a quarter of an f32 one. Writes
  quantize; cached reads go through the walk's int8 kernel. A
  from-zero chunk still attends to its exact K/V and writes them
  quantized, so under a prefix hit or chunked prefill a request reads
  quantized prefix K/V where a one-shot prefill read exact values (the
  boundary the JAX engine states too).
- weight-only int8 params (`serve.quant.quantize_params`): prefill reads
  the dequantized tree, each decode step and verify round dequantizes
  the resident int8 tree again (`transformer._int8_step_params`).

Speculative decoding (`serve(speculative=True)`): each round a proposer
(default `serve.speculative.NGramProposer`) drafts up to
`policy.spec_draft_max` tokens per slot from its history, the pages
under the window are reserved, ONE forward scores the window
(`spec_step`), the accepted prefix plus the verify's own token is
consumed, and the pool commits and rolls back the rejected tail. Greedy
requests keep the exact token contract.

State tensors are allocated once by `init_state` and updated in place
(K/V writes, page-table rows, per-slot scalars), so a step's shapes
never change.

Consistency contract: a GREEDY request yields the tokens of
`transformer.generate()` on the same prompt, whatever shares the pool,
whether its prefix came from the cache and whether its prefill was
chunked. Sampled requests draw from a per-slot `torch.Generator` seeded
from (engine seed, request identity); those draws are not JAX's.

Not ported yet (raise NotImplementedError): sliding-window ring pools
(`attn_window`), KV migration and serving artifacts. Also not yet here:
the JAX engine's pool-wide `select_fn`, custom scheduler `policy` and
prefix-cache knobs (the defaults are used).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.dtypes import at_least_f32, default_policy
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import sampling as sampling_ops
from paddle_tpu_torch.serve.paged import (PagePool, PoolExhaustedError,
                                          blocks_for)
from paddle_tpu_torch.serve.policy import SchedulerPolicy
from paddle_tpu_torch.serve.speculative import NGramProposer


@dataclass
class EngineState:
    """Device-resident pool state, updated in place. caches: per layer
    (k_arena, v_arena) [num_pages, page_size, Hkv, Dh], each an (s8,
    f32 scale [num_pages, page_size, Hkv]) pair under
    kv_cache_dtype="int8"; page_table [S,
    max_pages] int32 (sentinel num_pages on unmapped entries); pos [S]
    int32 next write position (sentinel max_len on inactive rows);
    active [S] bool; last_tok [S] int64; temp/top_k/top_p the slot's
    sampler; last_lp [S] f32 log p(last_tok | prefix); generators the
    per-slot sampling streams (None for greedy slots)."""

    caches: list
    page_table: torch.Tensor
    pos: torch.Tensor
    active: torch.Tensor
    last_tok: torch.Tensor
    temp: torch.Tensor
    top_k: torch.Tensor
    top_p: torch.Tensor
    last_lp: torch.Tensor
    generators: list


@dataclass
class PoolStats:
    """Host-side accounting for one serve() run: steps = decode_step
    calls (or verify rounds), tokens = emitted tokens, retried =
    preemption requeues; the page-pool counters at the end of the run.
    Speculative rounds: draft_proposed/draft_accepted count DRAFT tokens
    (the carry token of a round is not a draft), spec_reserved/
    spec_rolled_back the pool's page reserve/rollback ledger."""

    steps: int = 0
    tokens: int = 0
    prefills: int = 0
    requests: int = 0
    admitted: int = 0
    completed: int = 0
    retried: int = 0
    pages_in_use: int = 0
    pages_free: int = 0
    peak_pages_in_use: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefill_chunks: int = 0
    spec_rounds: int = 0
    draft_proposed: int = 0
    draft_accepted: int = 0
    spec_reserved: int = 0
    spec_rolled_back: int = 0


def pad_to_bucket(prompt, buckets):
    """(padded_prompt, true_len) for the smallest bucket >= the real
    length; buckets=None passes through unpadded."""
    t0 = int(prompt.shape[-1])
    if buckets is None:
        return prompt, t0
    fits = [b for b in sorted(buckets) if b >= t0]
    if not fits:
        raise ValueError(
            f"prompt len {t0} exceeds largest bucket {max(buckets)}")
    return np.pad(np.asarray(prompt), (0, fits[0] - t0)), t0


@dataclass
class PrefillTicket:
    """Host-side handle for one in-progress (possibly chunked) prefill."""

    slot: int
    prompt: np.ndarray          # bucket-padded prompt, int32
    true_len: int
    chunk: Optional[int]        # None = the rest in one chunk
    next_start: int
    temp: float
    top_k: int
    top_p: float
    req_tag: int
    req_seed: int


class DecodeEngine:
    """The executor of the serving stack: make once per (params, cfg,
    pool geometry); drive with `init_state` / `prefill` (or
    `prefill_begin`/`prefill_advance`) / `decode_step` /
    `ensure_decode_page` / `release_slot`, or just call `serve()`.

    device None -> cuda (raises without one); the params must already
    live on that device (`models.weights.params_from_numpy` or
    `transformer.init_params(..., device=...)`). Weight-only int8 params
    (`serve.quant.quantize_params`) are served as they are."""

    def __init__(self, params, cfg: T.TransformerConfig, *, slots: int,
                 max_len: int, eos_id: Optional[int] = None,
                 seed: int = 0, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 ragged_impl: Optional[str] = None,
                 device=None):
        if ragged_impl not in (None, "torch", "kernel"):
            raise ValueError(
                f"ragged_impl must be None|torch|kernel, got "
                f"{ragged_impl!r}")
        if cfg.kv_cache_dtype not in ("compute", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be compute|int8, got "
                f"{cfg.kv_cache_dtype!r}")
        if cfg.attn_window is not None:
            raise NotImplementedError(
                "sliding-window ring pools (attn_window) are not ported "
                "yet")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.device = resolve_device(device)
        # prefill reads the dequantized tree; each decode step and
        # verify round dequantizes the resident int8 tree again (the
        # same tree object for float params)
        self.params, self._step_params = T._int8_step_params(params)
        self.cfg = cfg
        self.policy = SchedulerPolicy()
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.seed = seed
        self.ragged_impl = ragged_impl
        self.page_size = page_size
        self.max_pages_per_slot = -(-max_len // page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else slots * self.max_pages_per_slot)
        if self.num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got "
                             f"{self.num_pages}")
        self.prefill_chunk = prefill_chunk
        self.pool: Optional[PagePool] = None  # built by init_state()
        self._admissions = 0

    # -- state ------------------------------------------------------------

    def init_state(self) -> EngineState:
        cfg, s, dev = self.cfg, self.slots, self.device
        policy = default_policy()
        shape = (self.num_pages, self.page_size, cfg.kv_heads, cfg.head_dim)

        def arena():
            if cfg.kv_cache_dtype == "int8":
                # zeros quantize to data 0 with the eps-floor scale
                return (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.full(shape[:-1], 1e-8 / 127.0,
                                   dtype=torch.float32, device=dev))
            return torch.zeros(shape, dtype=policy.compute_dtype, device=dev)

        self.pool = PagePool(
            num_pages=self.num_pages, page_size=self.page_size,
            slots=s, max_pages_per_slot=self.max_pages_per_slot)
        self._admissions = 0
        return EngineState(
            caches=[(arena(), arena()) for _ in self.params["blocks"]],
            page_table=torch.full((s, self.max_pages_per_slot),
                                  self.num_pages, dtype=torch.int32,
                                  device=dev),
            pos=torch.full((s,), self.max_len, dtype=torch.int32,
                           device=dev),
            active=torch.zeros(s, dtype=torch.bool, device=dev),
            last_tok=torch.zeros(s, dtype=torch.int64, device=dev),
            temp=torch.zeros(s, dtype=torch.float32, device=dev),
            top_k=torch.full((s,), cfg.vocab, dtype=torch.int32,
                             device=dev),
            top_p=torch.ones(s, dtype=torch.float32, device=dev),
            last_lp=torch.zeros(s, dtype=torch.float32, device=dev),
            generators=[None] * s)

    # -- token selection ---------------------------------------------------

    def _request_generator(self, req_tag: int, req_seed: int):
        """The request's own sampling stream, seeded from (engine seed,
        identity tag, request seed): its draws do not depend on pool
        co-tenants or admission order."""
        g = torch.Generator(device=self.device)
        mix = np.random.SeedSequence([self.seed, req_tag, req_seed])
        g.manual_seed(int(mix.generate_state(1, np.uint64)[0] >> 1))
        return g

    def _select(self, logits, temp, top_k, top_p, generators):
        """Next tokens [N] for logits [N, V]: argmax where every row is
        greedy (generator None), else per-row sampling; the host knows
        which, so the greedy step reads nothing back from the device."""
        if all(g is None for g in generators):
            return torch.argmax(at_least_f32(logits), dim=-1)
        gens = [g if g is not None else torch.Generator(logits.device)
                for g in generators]
        return sampling_ops.per_row_sample(logits, temp, top_k, top_p,
                                           generators=gens).long()

    # -- paged prefill (chunked, prefix-aware) -----------------------------

    def _chunk(self, state: EngineState, ticket: PrefillTicket,
               toks: np.ndarray, start: int, *, from_zero: bool,
               final: bool) -> None:
        """One prefill chunk for one slot: toks [chunk_w] at absolute
        positions start..start+chunk_w-1. A from_zero chunk runs causal
        attention within the chunk (the flash kernel on CUDA) and writes
        its K/V through the page table; a later chunk attends through
        the page table over everything cached so far (the ragged walk).
        The final chunk selects the request's first token and activates
        the slot."""
        cfg, params, dev = self.cfg, self.params, self.device
        slot, true_len = ticket.slot, ticket.true_len
        chunk_w = toks.shape[0]
        x = T._embed(params, torch.as_tensor(toks, device=dev)[None, :])
        ap = start + torch.arange(chunk_w, dtype=torch.int32, device=dev)
        pos = ap[None, :]
        pages_row = state.page_table[slot]
        if from_zero:
            lens = torch.tensor([true_len], dtype=torch.int32, device=dev)
            within = lambda q, k, v: T._attention(cfg, q, k, v, causal=True,
                                                  key_lens=lens)
            pg, off = pa.page_addresses(pages_row, ap,
                                        page_size=self.page_size)
        for p, (k_buf, v_buf) in zip(params["blocks"], state.caches):
            if from_zero:
                x, k, v = T._block_parts(cfg, p, x, pos, within)
                pa.write_kv_pair(k_buf, v_buf, k[0], v[0], pg, off)
            else:
                def cached(q, k, v, k_buf=k_buf, v_buf=v_buf):
                    return pa.paged_chunk_attention(
                        q, k, v, k_buf, v_buf, pages_row, start,
                        page_size=self.page_size, max_len=self.max_len,
                        impl=self.ragged_impl)[0]

                x, _, _ = T._block_parts(cfg, p, x, pos, cached)
        if not final:
            return
        x_last = x[0, true_len - 1 - start]
        logits = T._head(params, x_last[None])
        gen = (self._request_generator(ticket.req_tag, ticket.req_seed)
               if ticket.temp > 0 else None)
        state.temp[slot] = ticket.temp
        state.top_k[slot] = ticket.top_k
        state.top_p[slot] = ticket.top_p
        state.generators[slot] = gen
        one = slice(slot, slot + 1)
        first = self._select(logits, state.temp[one], state.top_k[one],
                             state.top_p[one], [gen])
        first_lp = torch.log_softmax(at_least_f32(logits), dim=-1)[
            0, first[0]]
        state.pos[slot] = true_len
        state.active[slot] = True
        state.last_tok[slot] = first[0]
        state.last_lp[slot] = first_lp

    # -- admission (begin/advance; prefill() drives both) ------------------

    def _validate_admission(self, prompt, true_len, sampling):
        t0 = int(prompt.shape[-1])
        if true_len is None:
            true_len = t0
        elif not (1 <= true_len <= t0):
            raise ValueError(f"true_len {true_len} not in [1, {t0}]")
        if t0 > self.max_len:
            raise ValueError(
                f"padded prompt len {t0} exceeds cache max_len "
                f"{self.max_len}")
        if true_len >= self.max_len:
            raise ValueError(
                f"prompt true_len {true_len} >= max_len "
                f"{self.max_len}: no room for a generated token")
        need = blocks_for(true_len, self.page_size)
        if need > self.num_pages:
            raise ValueError(
                f"prompt true_len {true_len} needs {need} pages "
                f"> page pool num_pages {self.num_pages}")
        sampling = sampling or {}
        unknown = set(sampling) - {"temperature", "top_k", "top_p", "seed"}
        if unknown:
            raise ValueError(f"unknown sampling keys {sorted(unknown)}")
        temp = sampling.get("temperature", 0.0)
        top_k = sampling.get("top_k")
        top_p = sampling.get("top_p")
        T._validate_sampler_args(temp, top_k, top_p)
        return true_len, temp, top_k, top_p, sampling.get("seed")

    def prefill_begin(self, state: EngineState, slot: int, prompt,
                      true_len: Optional[int] = None,
                      sampling: Optional[dict] = None):
        """Admit a request into `slot`: validate, consult the prefix
        cache, map the slot's pages (PoolExhaustedError leaves the pool
        untouched) and return (state, PrefillTicket). Run the forward
        with `prefill_advance`, once per chunk."""
        true_len, temp, top_k, top_p, req_seed = \
            self._validate_admission(prompt, true_len, sampling)
        if req_seed is None:
            req_tag, req_seed = 0, self._admissions
        else:
            req_tag = 1
        if self.pool is None:
            raise RuntimeError(
                "no page pool -- call init_state() before prefill")
        prompt_np = np.asarray(prompt, np.int32)
        pages, shared_len = self.pool.admit(slot, prompt_np, true_len)
        self._admissions += 1
        row = np.full((self.max_pages_per_slot,), self.num_pages, np.int32)
        row[:len(pages)] = pages
        state.page_table[slot] = torch.from_numpy(row).to(self.device)
        return state, PrefillTicket(
            slot=slot, prompt=prompt_np, true_len=true_len,
            chunk=self.prefill_chunk, next_start=shared_len,
            temp=float(temp),
            top_k=int(self.cfg.vocab if top_k is None else top_k),
            top_p=float(1.0 if top_p is None else top_p),
            req_tag=req_tag, req_seed=int(req_seed))

    def prefill_advance(self, state: EngineState, ticket: PrefillTicket):
        """Run ONE prefill chunk for the ticket; returns (state, done).
        The final chunk activates the slot and registers the prompt's
        full blocks in the prefix cache."""
        start = ticket.next_start
        t0 = int(ticket.prompt.shape[-1])
        width = ticket.chunk if ticket.chunk else (t0 - start)
        final = start + width >= ticket.true_len
        toks = ticket.prompt[start:start + width]
        if toks.shape[0] < width:
            toks = np.pad(toks, (0, width - toks.shape[0]))
        with torch.no_grad():
            self._chunk(state, ticket, toks, start,
                        from_zero=(start == 0), final=final)
        self.pool.prefill_chunks += 1
        ticket.next_start = start + width
        if final:
            self.pool.register(ticket.slot, ticket.prompt, ticket.true_len)
        return state, final

    def prefill(self, state: EngineState, slot: int, prompt,
                true_len: Optional[int] = None,
                sampling: Optional[dict] = None) -> EngineState:
        """Admit a request and run its whole prefill."""
        state, ticket = self.prefill_begin(state, slot, prompt,
                                           true_len=true_len,
                                           sampling=sampling)
        done = False
        while not done:
            state, done = self.prefill_advance(state, ticket)
        return state

    # -- the batched decode step ------------------------------------------

    def decode_step(self, state: EngineState):
        """Advance every active slot one token. Returns (state, emitted
        [S], emitted_lp [S], was_active [S], finished [S]): emitted[r] is
        meaningful where was_active[r]; finished rows just emitted their
        final token (eos or cache-full) -- callers still `release_slot`
        them so the host pool frees their pages."""
        cfg, L = self.cfg, self.max_len
        with torch.no_grad():
            params = self._step_params()
            x = T._embed(params, state.last_tok[:, None])
            pos = state.pos[:, None]
            for p, (k_buf, v_buf) in zip(params["blocks"], state.caches):
                def attn(q, k, v, k_buf=k_buf, v_buf=v_buf):
                    return pa.paged_decode_attention(
                        q, k, v, k_buf, v_buf, state.page_table, state.pos,
                        state.active, page_size=self.page_size, max_len=L,
                        impl=self.ragged_impl)[0]

                x, _, _ = T._block_parts(cfg, p, x, pos, attn)
            logits = T._head(params, x[:, -1])
            nxt = self._select(logits, state.temp, state.top_k,
                               state.top_p, state.generators)
            nxt_lp = torch.gather(
                torch.log_softmax(at_least_f32(logits), dim=-1), 1,
                nxt[:, None])[:, 0].float()
            emitted = state.last_tok.clone()
            emitted_lp = state.last_lp.clone()
            was_active = state.active.clone()
            fin = torch.zeros_like(was_active)
            if self.eos_id is not None:
                fin = was_active & (emitted == self.eos_id)
            fin = fin | (was_active & (state.pos + 1 >= L))
            cont = was_active & ~fin
            state.pos.copy_(torch.where(cont, state.pos + 1,
                                        torch.full_like(state.pos, L)))
            state.active.copy_(cont)
            state.last_tok.copy_(nxt)
            state.last_lp.copy_(nxt_lp)
        return state, emitted, emitted_lp, was_active, fin

    def ensure_decode_page(self, state: EngineState,
                           slot: int) -> EngineState:
        """Advance the host page bookkeeping for one continuing slot:
        map the next write position's block when it crosses into an
        unmapped one. Raises PoolExhaustedError (position not advanced)
        when no page is available."""
        res = self.pool.extend(slot)
        if res is not None:
            blk, page = res
            state.page_table[slot, blk] = page
        return state

    def release_slot(self, state: EngineState, slot: int) -> EngineState:
        """Retire one slot: deactivate the row, park its pos on the
        out-of-range sentinel, free its pages (refcounted) and reset its
        page-table row to the drop sentinel."""
        if self.pool is not None:
            self.pool.release(slot)
            state.page_table[slot] = self.num_pages
        state.active[slot] = False
        state.pos[slot] = self.max_len
        state.generators[slot] = None
        return state

    # -- the speculative verify round --------------------------------------

    def spec_step(self, state: EngineState, drafts, draft_len):
        """One speculative verify round over the pool: score each slot's
        drafts against the target in ONE forward over the window (the
        carry token plus the K drafts), accept the distribution-
        preserving prefix, carry the break position's token as the next
        round's. drafts [S, K] / draft_len [S] are host arrays (entries
        past draft_len[r] arbitrary), staged as one tensor each.

        Returns (state, emitted [S, K+1], emitted_lp [S, K+1], n_emit
        [S], was_active [S], finished [S], n_accepted [S]): row r emitted
        emitted[r, :n_emit[r]] this round. The caller must have reserved
        pages under pos..pos+draft_len[r] (`reserve_spec_pages`) and
        settles continuing rows with `settle_spec` after."""
        cfg, L, dev = self.cfg, self.max_len, self.device
        d = torch.from_numpy(np.asarray(drafts, np.int64)).to(dev)
        dl = torch.from_numpy(np.asarray(draft_len, np.int64)).to(dev)
        k = d.shape[1]
        with torch.no_grad():
            params = self._step_params()
            window = torch.cat([state.last_tok[:, None], d], dim=1)
            x = T._embed(params, window)
            pos = state.pos[:, None] + torch.arange(
                k + 1, dtype=torch.int32, device=dev)[None, :]
            for p, (k_buf, v_buf) in zip(params["blocks"], state.caches):
                # write the whole window's K/V through the table, then
                # the ragged read at per-row offsets; rejected positions
                # are rolled back on the host (pool.commit) and
                # rewritten before any later read
                def attn(q, kk, vv, k_buf=k_buf, v_buf=v_buf):
                    return pa.paged_verify_attention(
                        q, kk, vv, k_buf, v_buf, state.page_table,
                        state.pos, state.active, page_size=self.page_size,
                        max_len=L, impl=self.ragged_impl)[0]

                x, _, _ = T._block_parts(cfg, p, x, pos, attn)
            logits = T._head(params, x)                     # [S, K+1, V]
            # an all-greedy pool takes the sort-free argmax rule, as the
            # plain step takes argmax; the host knows which
            if all(g is None for g in state.generators):
                nxt, n_acc, lp_draft, lp_next = \
                    sampling_ops.greedy_spec_verify(logits, window, dl)
            else:
                gens = [g if g is not None else torch.Generator(dev)
                        for g in state.generators]
                nxt, n_acc, lp_draft, lp_next = \
                    sampling_ops.ngram_spec_verify(
                        logits, window, dl, state.temp, state.top_k,
                        state.top_p, generators=gens)
            # a round CONSUMES window[:n_acc+1] and emits each consumed
            # token (generate()'s emit-the-carry convention per token)
            emitted = window
            emitted_lp = torch.cat([state.last_lp[:, None], lp_draft], dim=1)
            was_active = state.active.clone()
            n_con = n_acc + 1
            fin = torch.zeros_like(was_active)
            n_emit = n_con
            if self.eos_id is not None:
                # eos anywhere in the consumed prefix finishes the row at
                # that token; later accepted tokens go with the row
                is_eos = (window == self.eos_id) & (
                    torch.arange(k + 1, device=dev)[None, :]
                    < n_con[:, None])
                has_eos = is_eos.any(dim=1)
                n_emit = torch.where(
                    has_eos, torch.argmax(is_eos.to(torch.int32), dim=1) + 1,
                    n_con)
                fin = was_active & has_eos
            # capacity: policy.draft_len keeps pos + n_emit <= L
            fin = fin | (was_active & (state.pos + n_emit >= L))
            cont = was_active & ~fin
            state.pos.copy_(torch.where(cont, state.pos + n_emit,
                                        torch.full_like(state.pos, L)))
            state.active.copy_(cont)
            state.last_tok.copy_(nxt)
            state.last_lp.copy_(lp_next)
        return state, emitted, emitted_lp, n_emit, was_active, fin, n_acc

    def reserve_spec_pages(self, state: EngineState, slot: int,
                           k: int) -> EngineState:
        """Map the verify window's write blocks for one slot BEFORE a
        spec_step (pool.reserve: all or nothing, pos untouched). Raises
        PoolExhaustedError with pool and table unchanged; the caller
        degrades the slot to a 0-draft round."""
        for blk, page in self.pool.reserve(slot, k):
            state.page_table[slot, blk] = page
        return state

    def settle_spec(self, state: EngineState, slot: int,
                    n_emit: int) -> EngineState:
        """Settle one CONTINUING slot after a spec_step consumed n_emit
        tokens: pool.commit advances pos, maps the next write block when
        full acceptance crossed a boundary (may raise PoolExhaustedError
        with pos NOT advanced, like ensure_decode_page) and rolls the
        rejected tail's pages back; their table entries return to the
        drop sentinel."""
        added, dropped = self.pool.commit(slot, n_emit)
        for blk, page in added:
            state.page_table[slot, blk] = page
        for blk in dropped:
            state.page_table[slot, blk] = self.num_pages
        return state

    # -- not ported yet ------------------------------------------------------

    def pause_slot(self, state, slot):
        raise NotImplementedError("KV-block migration is not ported yet")

    def export_slot_kv(self, state, pages):
        raise NotImplementedError("KV-block migration is not ported yet")

    def import_slot_kv(self, state, slot, pages, *args, **kwargs):
        raise NotImplementedError("KV-block migration is not ported yet")

    def resume_slot(self, state, slot, seed):
        raise NotImplementedError("KV-block migration is not ported yet")

    def bind_artifact(self, programs, manifest):
        raise NotImplementedError("serving artifacts are not ported yet")

    # -- the host loop -----------------------------------------------------

    def _propose(self, state, proposer, prompt_hist, emitted, remaining,
                 slot_req, pending, stats):
        """One round's drafts: per decoding slot, up to the policy's
        draft budget from the proposer over the request's true prompt and
        its output so far, with the window's pages reserved; a slot that
        finds no pages runs a 0-draft round (never a preemption for
        speculative work). Returns (drafts [S, K], draft_len [S])."""
        kmax = int(self.policy.spec_draft_max)
        drafts = np.zeros((self.slots, kmax), np.int64)
        dlen = np.zeros((self.slots,), np.int64)
        draft_fn = getattr(proposer, "draft", proposer.propose)
        for slot, req in enumerate(slot_req):
            if req == -1 or slot in pending:
                continue
            budget = self.policy.draft_len(
                pos=self.pool.slot_pos[slot], max_len=self.max_len,
                remaining=remaining[req])
            prop = (draft_fn(prompt_hist[req] + emitted[req],
                             budget)[:budget] if budget > 0 else [])
            if prop:
                try:
                    state = self.reserve_spec_pages(state, slot, len(prop))
                except PoolExhaustedError:
                    prop = []
            drafts[slot, :len(prop)] = prop
            dlen[slot] = len(prop)
            stats.draft_proposed += len(prop)
        return drafts, dlen


    def serve(self, prompts, *, max_new: int, buckets=None,
              sampling=None, return_logprobs: bool = False,
              speculative: bool = False, proposer=None):
        """Serve a list of 1-D int prompts through the S-slot pool: admit
        while slots AND pages are free, step, collect, refill. Returns
        per-request generated-token lists (eos included, like
        generate()), and per-token log-probabilities with
        return_logprobs. On page-pool exhaustion mid-decode the policy's
        victim is preempted back onto the queue (its decode restarts,
        tokens identical), or a lone request retires at pool capacity.

        speculative: decode in draft/verify rounds instead of one-token
        steps -- each round scores up to policy.spec_draft_max drafts per
        slot from `proposer` (default NGramProposer(); its
        propose(history, k), or draft(history, k) where it has one) in
        ONE forward and consumes the accepted prefix plus the verify's
        own token. Greedy requests keep the exact token contract;
        sampled ones keep the output distribution. A slot whose window
        finds no pages runs a 0-draft round (never a preemption for
        speculative work)."""
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if sampling is not None and len(sampling) != len(prompts):
            raise ValueError(
                f"sampling has {len(sampling)} entries for "
                f"{len(prompts)} prompts")
        if buckets is not None:
            too_big = [b for b in buckets if b > self.max_len]
            if too_big:
                raise ValueError(
                    f"buckets {too_big} exceed max_len {self.max_len}: "
                    f"padded prefills cannot fit the cache")
        prompts = [np.asarray(p) for p in prompts]
        for i, p in enumerate(prompts):
            t0 = int(p.shape[-1])
            if t0 < 1:
                raise ValueError(f"prompt {i} is empty (need >= 1 token)")
            if buckets is not None and t0 > max(buckets):
                raise ValueError(
                    f"prompt {i} len {t0} exceeds largest bucket "
                    f"{max(buckets)}")
            if t0 >= self.max_len:
                raise ValueError(
                    f"prompt {i} true_len {t0} >= max_len {self.max_len}: "
                    f"no room for a generated token")
            need = blocks_for(t0, self.page_size)
            if need > self.num_pages:
                raise ValueError(
                    f"prompt {i} needs {need} pages > page pool "
                    f"num_pages {self.num_pages}")

        prompt_hist: list = []
        if speculative:
            if int(self.policy.spec_draft_max) < 1:
                raise ValueError(
                    f"policy.spec_draft_max must be >= 1, got "
                    f"{self.policy.spec_draft_max}")
            if proposer is None:
                proposer = NGramProposer()
            # the proposer's view: the TRUE prompt (unpadded) plus
            # everything emitted so far, host ints only
            prompt_hist = [[int(x) for x in p.reshape(-1)] for p in prompts]

        state = self.init_state()
        stats = PoolStats(requests=len(prompts))
        queue = list(range(len(prompts)))
        slot_req = [-1] * self.slots
        pending: dict = {}
        emitted: dict = {i: [] for i in range(len(prompts))}
        lps: dict = {i: [] for i in range(len(prompts))}
        remaining = [max_new] * len(prompts)

        def admit():
            nonlocal state
            for slot in range(self.slots):
                if slot_req[slot] != -1 or not queue:
                    continue
                idx = self.policy.next_index(queue)
                req = queue[idx]
                padded, true_len = pad_to_bucket(prompts[req], buckets)
                if not self.policy.can_admit(self.pool, padded, true_len):
                    break
                try:
                    state, ticket = self.prefill_begin(
                        state, slot, padded, true_len=true_len,
                        sampling=(sampling[req] if sampling else None))
                except PoolExhaustedError:
                    break
                queue.pop(idx)
                slot_req[slot] = req
                stats.prefills += 1
                stats.admitted += 1
                if ticket.chunk is None:
                    done = False
                    while not done:
                        state, done = self.prefill_advance(state, ticket)
                else:
                    pending[slot] = ticket

        def preempt_or_retire(slot: int) -> bool:
            nonlocal state
            holders = [s_ for s_ in range(self.slots) if slot_req[s_] != -1]
            s_v = self.policy.preemption_victim(
                [(s_, slot_req[s_]) for s_ in holders])
            if s_v == slot and len(holders) == 1:
                state = self.release_slot(state, slot)
                slot_req[slot] = -1
                stats.completed += 1
                return False
            req_v = slot_req[s_v]
            state = self.release_slot(state, s_v)
            pending.pop(s_v, None)
            slot_req[s_v] = -1
            emitted[req_v] = []
            lps[req_v] = []
            remaining[req_v] = max_new
            queue.insert(0, req_v)
            stats.retried += 1
            return s_v != slot

        admit()
        while any(r != -1 for r in slot_req):
            for slot in self.policy.prefill_slots(list(pending)):
                ticket = pending.get(slot)
                if ticket is None:
                    continue
                state, done = self.prefill_advance(state, ticket)
                if done:
                    del pending[slot]
            decoding = sum(slot_req[s_] != -1 and s_ not in pending
                           for s_ in range(self.slots))
            if not self.policy.should_decode(decoding, len(pending)):
                continue
            if speculative:
                # propose -> reserve -> verify in one forward -> settle
                drafts, dlen = self._propose(state, proposer, prompt_hist,
                                             emitted, remaining, slot_req,
                                             pending, stats)
                state, em, em_lp, n_emit, was_active, fin, n_acc = \
                    self.spec_step(state, drafts, dlen)
                stats.spec_rounds += 1
            else:
                state, toks, tok_lps, was_active, fin = \
                    self.decode_step(state)
                em, em_lp = toks[:, None], tok_lps[:, None]
            stats.steps += 1
            # ONE host sync per step or round: the admission decision
            # needs it
            cols = [was_active, fin] + (
                [n_emit, n_acc] if speculative else [])
            host = torch.cat([em.double(), em_lp.double(),
                              torch.stack([c.double() for c in cols],
                                          dim=1)], dim=1).cpu()
            k1 = em.shape[1]
            em_h = host[:, :k1].long().tolist()
            lp_h = host[:, k1:2 * k1].tolist()
            was_active_h = host[:, 2 * k1].bool().tolist()
            fin_h = host[:, 2 * k1 + 1].bool().tolist()
            if speculative:
                n_emit_h = host[:, 2 * k1 + 2].long().tolist()
                n_acc_h = host[:, 2 * k1 + 3].long().tolist()
            else:
                n_emit_h, n_acc_h = [1] * self.slots, [0] * self.slots
            freed = False
            for slot in range(self.slots):
                req = slot_req[slot]
                if req == -1 or slot in pending or not was_active_h[slot]:
                    continue
                ne = n_emit_h[slot]
                stats.draft_accepted += n_acc_h[slot]
                emitted[req].extend(em_h[slot][:ne])
                lps[req].extend(lp_h[slot][:ne])
                stats.tokens += ne
                remaining[req] -= ne
                if fin_h[slot] or remaining[req] <= 0:
                    # release also frees a round's reserved-but-rejected
                    # pages
                    state = self.release_slot(state, slot)
                    slot_req[slot] = -1
                    stats.completed += 1
                    freed = True
                    continue
                # continuing row: map the next write block (and, after a
                # round, roll the rejected tail's pages back)
                while True:
                    try:
                        if speculative:
                            state = self.settle_spec(state, slot, ne)
                        else:
                            state = self.ensure_decode_page(state, slot)
                        break
                    except PoolExhaustedError:
                        if not preempt_or_retire(slot):
                            freed = True
                            break
            if freed or queue:
                admit()
        toks_out = [emitted[i] for i in range(len(prompts))]
        pc = self.pool.counters()
        for k in ("pages_in_use", "pages_free", "peak_pages_in_use",
                  "prefix_hits", "prefix_misses", "prefill_chunks",
                  "spec_reserved", "spec_rolled_back"):
            setattr(stats, k, pc[k])
        self.last_stats = stats
        if return_logprobs:
            return toks_out, [lps[i] for i in range(len(prompts))]
        return toks_out
