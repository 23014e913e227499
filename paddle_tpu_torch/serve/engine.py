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

Mixture-of-experts configs ride the same `_block_parts` body. Expert
capacity is a function of a call's token count, so every call passes
the router a token mask: a prefill chunk's bucket pads and padded tail,
a decode step's inactive slots and a verify window's positions past a
row's draft_len claim no capacity (without it they would evict real
tokens under a tight `moe_capacity_factor`). A pool step routes its
live rows together, so a pathologically imbalanced step can drop a
token that a solo `generate` would not, as in the JAX engine.

Sliding-window configs (`attn_window`) hold [S, window] RING pools
instead of paged arenas: position p of a row lives at ring slot p mod
window (`transformer._ring_slot_valid`), a prompt prefills in one shot
(kernel A on CUDA, with the window and the row's key bound together)
and each decode step is the plain `transformer._cached_attention` with
a per-row slot vector. A ring row retires on eos or its token budget
only: the ring never fills.

KV-block migration (disaggregated prefill/decode): `pause_slot` parks
a row and snapshots its decode state (`DecodeSeed`, the slot's
generator state included), `export_slot_kv` copies its pages to the
host verbatim, `import_slot_kv` writes them into another engine's
arena (pages shared through that pool's prefix cache are skipped) and
`resume_slot` brings the row live there: a greedy request's next token
is the one the source would have emitted.

Serving artifacts (`serve.artifact`): `bind_artifact` installs
programs exported with `torch.export` -- the decode step, the
speculative verify round and the saved prefill-chunk widths, each
greedy or sampled where the host picks one or the other -- and
`decode_step`, `spec_step` and each prefill chunk run them in place of
the eager bodies. The programs take the engine's weights as inputs
(the bundle holds none; its manifest's `params_hash` binds it to one
weight tree) and the state tensors, which they update in place as the
eager bodies do. Host integers (slot, start, true_len) enter as 0-d
tensors, and a sampled program takes the Gumbel noise and acceptance
uniforms the engine draws from the slots' own generators exactly as
the eager body would, so a bundle serves the eager engine's tokens. A
bound program that fails is dropped for good, counted in
`artifact_fallbacks` and reported to `_artifact_hook`; the eager body
serves that call and every later one.

Tensor-parallel pools: `params` may be DTensors placed by
`transformer.TP_RULES` (`parallel.sharding.make_param_shardings`). The
K/V arenas (float, or int8 with their scale planes) are then DTensors
on the parameters' mesh with the heads dim split over its `model` axis
(each rank holds the local shard's `kv_geometry`: kv_heads over the
axis size); page tables, positions and tokens stay plain (replicated)
tensors, and the tokens are read back once a step as in one process.
Each cached read walks each rank's own heads through kernel B's or C's
DTensor sharding rule (`ops.paged_attention`). Paged pools only: a
ring (sliding-window) pool, KV migration and the artifact programs take
plain tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.dtypes import at_least_f32, default_policy
from paddle_tpu_torch.core.mesh import gather_full
from paddle_tpu_torch.core.pytree import flatten_with_keys, tree_leaves
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import sampling as sampling_ops
from paddle_tpu_torch.serve import quant as _quant
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
    The outcome counters are the serving server's per-request ledger:
    every submitted request lands in exactly one of completed/expired/
    shed/failed. Speculative rounds: draft_proposed/draft_accepted
    count DRAFT tokens (the carry token of a round is not a draft),
    spec_reserved/spec_rolled_back the pool's page reserve/rollback
    ledger."""

    steps: int = 0
    tokens: int = 0
    prefills: int = 0
    requests: int = 0
    admitted: int = 0
    completed: int = 0
    expired: int = 0
    shed: int = 0
    failed: int = 0
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

    def acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens."""
        return self.draft_accepted / max(self.draft_proposed, 1)


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
    windowed: bool = False      # ring pool: one-shot prefill


@dataclass
class DecodeSeed:
    """Host-side snapshot of one slot's per-row decode state, taken by
    `pause_slot` and replayed by `resume_slot` on the migration
    destination: everything the step reads per row except the KV
    blocks (those ride the page export). Carrying last_tok/last_lp
    makes the destination's first step emit exactly the token the
    source's would have. rng_key_data holds the slot generator's
    `get_state()` bytes (empty for a greedy slot, which has none), so a
    sampled request continues its own stream after the move."""

    pos: int
    last_tok: int
    last_lp: float
    temp: float
    top_k: int
    top_p: float
    rng_key_data: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.uint8))


def state_leaves(state: EngineState) -> list:
    """The state's tensors in the order the exported programs take
    them: per layer the K arena then the V arena (an int8 arena as its
    data then its scale), then page_table, pos, active, last_tok, temp,
    top_k, top_p, last_lp. The generators stay on the host."""
    out = []
    for k_buf, v_buf in state.caches:
        for buf in (k_buf, v_buf):
            out.extend(buf if isinstance(buf, tuple) else (buf,))
    return out + [state.page_table, state.pos, state.active,
                  state.last_tok, state.temp, state.top_k, state.top_p,
                  state.last_lp]


def state_from_leaves(leaves, *, n_layers: int, int8: bool,
                      slots: int) -> EngineState:
    """`state_leaves`' inverse (generators all None)."""
    leaves = list(leaves)
    per = 2 if int8 else 1
    caches = []
    for i in range(n_layers):
        bufs = leaves[2 * per * i:2 * per * (i + 1)]
        if int8:
            caches.append(((bufs[0], bufs[1]), (bufs[2], bufs[3])))
        else:
            caches.append((bufs[0], bufs[1]))
    rest = leaves[2 * per * n_layers:]
    return EngineState(caches, *rest, generators=[None] * slots)


def chunk_key(width: int, from_zero: bool, final: bool) -> str:
    """The bundle's name of a prefill-chunk program."""
    return (f"chunk_w{int(width)}_z{int(bool(from_zero))}"
            f"_f{int(bool(final))}")


#: what `_run_art` returns when the eager body must serve the call
_MISS = object()


def _scalar(value, dtype, device):
    """A host number as a 0-d device tensor: how the prefill hands slot,
    start, true_len and the sampler to its body, so an exported chunk
    program takes them as inputs rather than baking them in."""
    return torch.tensor(value, dtype=dtype, device=device)


def _put(buf, idx, value):
    """buf[idx] = value for a 1-element index tensor, as one in-place
    index_copy_ (no host read of idx)."""
    buf.index_copy_(0, idx, value.reshape(1).to(buf.dtype))


class DecodeEngine:
    """The executor of the serving stack: make once per (params, cfg,
    pool geometry); drive with `init_state` / `prefill` (or
    `prefill_begin`/`prefill_advance`) / `decode_step` /
    `ensure_decode_page` / `release_slot`, or just call `serve()`.
    Scheduling decisions inside `serve()` (admission order, preemption
    victim, prefill interleave) route through `policy`.

    device None -> cuda (raises without one); the params must already
    live on that device (`models.weights.params_from_numpy` or
    `transformer.init_params(..., device=...)`). Weight-only int8 params
    (`serve.quant.quantize_params`) are served as they are.

    select_fn(logits [B, V], generator) -> [B] overrides token selection
    pool-wide (exclusive with per-request sampling). Where JAX passes
    slot 0's key, the port passes slot 0's `torch.Generator`: under a
    select_fn every request gets its own generator at admission, and a
    step whose slot 0 is empty passes the pool's own generator (seeded
    from `seed`). A first token is selected with the request's own
    generator. `prefix_cache`/`prefix_cache_blocks` configure the page
    pool's shared-prefix cache."""

    def __init__(self, params, cfg: T.TransformerConfig, *, slots: int,
                 max_len: int, eos_id: Optional[int] = None,
                 select_fn=None, seed: int = 0, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefix_cache_blocks: int = 512,
                 policy: Optional[SchedulerPolicy] = None,
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
        self.policy = policy if policy is not None else SchedulerPolicy()
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.select_fn = select_fn
        self.seed = seed
        self.ragged_impl = ragged_impl
        self.paged = cfg.attn_window is None
        self.page_size = page_size
        self.max_pages_per_slot = -(-max_len // page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else slots * self.max_pages_per_slot)
        if self.num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got "
                             f"{self.num_pages}")
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = prefix_cache
        self.prefix_cache_blocks = prefix_cache_blocks
        self._raw_params = params   # the step programs' (int8) tree
        # tensor-parallel parameters (DTensors): the mesh the arenas are
        # split over, heads on its "model" dim
        leaf = next(iter(tree_leaves(params)), None)
        self._tp_mesh = getattr(leaf, "device_mesh", None)
        if self._tp_mesh is not None:
            self._tp_check()
        self.pool: Optional[PagePool] = None  # built by init_state()
        self._admissions = 0
        self._pool_gen = None   # select_fn's stand-in for an empty slot 0
        # serving artifacts (serve.artifact): bound programs replace the
        # eager bodies call for call; None = the eager path
        self._artifact: Optional[dict] = None
        self.artifact_loads = 0
        self.artifact_fallbacks = 0
        self._artifact_hook = None

    def _tp_check(self) -> None:
        """A tensor-parallel pool: paged, and heads that divide over the
        mesh's model axis."""
        if not self.paged:
            raise ValueError("a tensor-parallel (DTensor) engine needs a "
                             "paged pool; ring pools take plain params")
        tp = self._tp_size()
        for what, n in (("n_heads", self.cfg.n_heads),
                        ("kv_heads", self.cfg.kv_heads)):
            if n % tp:
                raise ValueError(f"{what} {n} does not split over the "
                                 f"{tp}-rank model axis")

    def _tp_size(self) -> int:
        names = self._tp_mesh.mesh_dim_names or ()
        return (self._tp_mesh.size(names.index("model"))
                if "model" in names else 1)

    def _tp_arena(self, local):
        """A local arena shard (this rank's heads) as the pool's DTensor
        arena: heads split over the mesh's model dim."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        names = self._tp_mesh.mesh_dim_names or ()
        placements = [Shard(2) if n == "model" else Replicate()
                      for n in names]
        shape = list(local.shape)
        shape[2] *= self._tp_size()
        shape = torch.Size(shape)
        return DTensor.from_local(local, self._tp_mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    def _replicated(self):
        """The context of a device body: plain tensors count as
        replicated over a tensor-parallel pool's mesh."""
        return T._plain_replicated(self._raw_params)

    def ping(self) -> None:
        """The health-probe surface: a host-side liveness touch (no
        device work). The real engine always answers; a dead-replica
        proxy (testing.faults) raises here as a lost device would."""
        return None

    # -- serving-artifact surface (serve.artifact) -------------------------

    def state_spec(self) -> EngineState:
        """init_state()'s tensors as "meta" tensors (shape and dtype, no
        storage), from config arithmetic alone. serve.artifact builds
        the exported programs' example inputs from it. Paged engines
        only: ring configs keep the eager path."""
        if not self.paged:
            raise ValueError(
                "state_spec/engine artifacts support paged engines only "
                "(attn_window configs keep the eager path)")
        cfg, s = self.cfg, self.slots
        meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                                device="meta")
        shape = (self.num_pages, self.page_size, cfg.kv_heads,
                 cfg.head_dim)

        def arena():
            if cfg.kv_cache_dtype == "int8":
                return (meta(shape, torch.int8),
                        meta(shape[:-1], torch.float32))
            return meta(shape, default_policy().compute_dtype)

        return EngineState(
            caches=[(arena(), arena()) for _ in self.params["blocks"]],
            page_table=meta((s, self.max_pages_per_slot), torch.int32),
            pos=meta((s,), torch.int32), active=meta((s,), torch.bool),
            last_tok=meta((s,), torch.int64),
            temp=meta((s,), torch.float32), top_k=meta((s,), torch.int32),
            top_p=meta((s,), torch.float32),
            last_lp=meta((s,), torch.float32), generators=[None] * s)

    def artifact_manifest(self) -> dict:
        """Everything a bundle's programs depend on, as JSON primitives:
        the PyTorch version and device type they were exported with, the
        compute and KV dtypes, the config, the weight tree (hashed over
        names, shapes, dtypes and bytes), the pool geometry, eos, seed,
        the speculative width and the walk's impl. A loader refuses a
        bundle whose manifest differs in ANY field
        (serve.artifact.load_engine_artifact)."""
        import hashlib

        if self.select_fn is not None:
            raise ValueError(
                "engine artifacts need select_fn=None: a pool-wide "
                "select_fn is a Python closure no manifest can verify "
                "(per-request sampling is supported)")
        if not self.paged:
            raise ValueError("engine artifacts support paged engines only")
        h = hashlib.sha256()
        for name, leaf in flatten_with_keys(self._raw_params):
            t = leaf.detach().cpu().contiguous()
            h.update(name.encode())
            h.update(str(tuple(t.shape)).encode())
            h.update(str(t.dtype).encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        return {
            "kind": "engine",
            "torch_version": torch.__version__,
            "device_type": self.device.type,
            "compute_dtype": str(default_policy().compute_dtype),
            "kv_cache_dtype": self.cfg.kv_cache_dtype,
            "cfg_hash": hashlib.sha256(
                repr(self.cfg).encode()).hexdigest()[:16],
            "params_hash": h.hexdigest(),
            "slots": int(self.slots),
            "max_len": int(self.max_len),
            "page_size": int(self.page_size),
            "num_pages": int(self.num_pages),
            "max_pages_per_slot": int(self.max_pages_per_slot),
            "eos_id": None if self.eos_id is None else int(self.eos_id),
            "seed": int(self.seed),
            "spec_draft_max": int(self.policy.spec_draft_max),
            "ragged_impl": self.ragged_impl or "auto",
        }

    def bind_artifact(self, programs: dict, manifest: dict) -> None:
        """Install loaded programs (serve.artifact.load_engine_artifact
        builds the dict, already verified against this engine): later
        decode steps, verify rounds and prefill chunks of a saved width
        run through them.

        JAX's bundle also carries the page-table and retire setters; in
        the port those are plain in-place writes with no compile to
        skip, so they stay eager and the bundle holds none."""
        del manifest  # verified by the loader; nothing here depends on it
        self._artifact = dict(programs)
        self.artifact_loads += 1

    def artifact_fallback(self, member: str, error: str) -> None:
        """Record one artifact->eager fallback (a refused bundle or a
        bound program failing): bump the counter the server and router
        export and tell the observability hook (ServingServer points it
        at its flight recorder)."""
        self.artifact_fallbacks += 1
        if self._artifact_hook is not None:
            self._artifact_hook(member, error)

    def _art(self, name: str):
        art = self._artifact
        return None if art is None else art.get(name)

    def _art_drop(self, name: str, exc: Exception) -> None:
        # a program that failed once would fail every call: drop it so
        # the steady loop does not pay an exception per step
        if self._artifact is not None:
            self._artifact.pop(name, None)
        self.artifact_fallback(name, repr(exc))

    def _run_art(self, name: str, params, state, *args):
        """The bound program `name`'s outputs on (params, state, *args),
        or _MISS when there is none or it failed (dropped and counted;
        the caller runs the eager body). A program checks its inputs
        before it runs, so a refused call leaves the state untouched."""
        fn = self._art(name)
        if fn is None:
            return _MISS
        try:
            return fn(params, state, *args)
        except Exception as e:
            self._art_drop(name, e)
            return _MISS

    # -- state ------------------------------------------------------------

    def init_state(self) -> EngineState:
        cfg, s, dev = self.cfg, self.slots, self.device
        policy = default_policy()
        # this rank's heads: a tensor-parallel pool's local shard
        hkv, dh = self.kv_geometry()["kv_heads"], cfg.head_dim
        tp = self._tp_mesh is not None
        if self.paged:
            # block-paged arenas addressed through the page table
            shape = (self.num_pages, self.page_size, hkv, dh)
            self.pool = PagePool(
                num_pages=self.num_pages, page_size=self.page_size,
                slots=s, max_pages_per_slot=self.max_pages_per_slot,
                prefix_cache=self.prefix_cache,
                prefix_cache_blocks=self.prefix_cache_blocks)
            table = torch.full((s, self.max_pages_per_slot), self.num_pages,
                               dtype=torch.int32, device=dev)
        else:
            # sliding-window configs: one [window] ring per slot
            shape = (s, cfg.attn_window, hkv, dh)
            self.pool = None
            table = torch.zeros((s, 1), dtype=torch.int32, device=dev)

        def arena():
            if cfg.kv_cache_dtype == "int8":
                # zeros quantize to data 0 with the eps-floor scale
                pair = (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.full(shape[:-1], 1e-8 / 127.0,
                                   dtype=torch.float32, device=dev))
                return (tuple(self._tp_arena(t) for t in pair) if tp
                        else pair)
            buf = torch.zeros(shape, dtype=policy.compute_dtype, device=dev)
            return self._tp_arena(buf) if tp else buf

        self._admissions = 0
        self._pool_gen = None
        if self.select_fn is not None:
            self._pool_gen = torch.Generator(device=dev)
            self._pool_gen.manual_seed(int(self.seed))
        return EngineState(
            caches=[(arena(), arena()) for _ in self.params["blocks"]],
            page_table=table,
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

    def _select(self, logits, temp, top_k, top_p, generators, noise=None):
        """Next tokens [N] for logits [N, V]: the pool-wide select_fn
        (given the first row's generator), argmax where no Gumbel draws
        are given, else per-row sampling with the draws noise [N, V]
        (the rows' own, `_draws`; temperature 0 rows take the same
        argmax). The host knows which, so a greedy step reads nothing
        back from the device."""
        if self.select_fn is not None:
            gen = generators[0] if generators[0] is not None \
                else self._pool_gen
            return self.select_fn(logits, gen).long()
        if noise is None:
            return torch.argmax(at_least_f32(logits), dim=-1)
        return sampling_ops.per_row_sample(logits, temp, top_k, top_p,
                                           noise=noise).long()

    # -- paged prefill (chunked, prefix-aware) -----------------------------

    def _chunk(self, state: EngineState, ticket: PrefillTicket,
               toks: np.ndarray, start: int, *, from_zero: bool,
               final: bool) -> None:
        """One prefill chunk for one slot: the bound program of its
        (width, from_zero, final) where the bundle saved one, else the
        eager `_chunk_impl`. The host's part: the request's generator
        and, for a sampled request's final chunk, its first draw."""
        dev, v = self.device, self.cfg.vocab
        gen = noise = None
        if final and (ticket.temp > 0 or self.select_fn is not None):
            gen = self._request_generator(ticket.req_tag, ticket.req_seed)
            if self.select_fn is None:
                noise = sampling_ops._row_draws(1, v, [gen], dev,
                                                gumbel=True)
        args = (_scalar(ticket.slot, torch.int64, dev),
                torch.as_tensor(toks, dtype=torch.int32, device=dev),
                _scalar(start, torch.int64, dev),
                _scalar(ticket.true_len, torch.int64, dev),
                _scalar(ticket.temp, torch.float32, dev),
                _scalar(ticket.top_k, torch.int32, dev),
                _scalar(ticket.top_p, torch.float32, dev))
        # a width the bundle does not hold (a prefix hit's remainder)
        # is an expected miss: the eager body serves it, uncounted
        key = chunk_key(toks.shape[0], from_zero, final)
        ran = self._run_art(key, self.params, state, *args,
                            torch.zeros((1, v), device=dev)
                            if noise is None else noise)
        if ran is _MISS:
            with self._replicated():
                self._chunk_impl(self.params, state, *args, noise, gen=gen,
                                 from_zero=from_zero, final=final)
        if final:
            state.generators[ticket.slot] = gen

    def _chunk_impl(self, params, state: EngineState, slot, toks, start,
                    true_len, temp, top_k, top_p, noise, *, gen=None,
                    from_zero: bool, final: bool) -> None:
        """The chunk's device work: toks [chunk_w] at absolute positions
        start..start+chunk_w-1 (slot, start, true_len and the sampler
        are 0-d tensors, read on the device only). A from_zero chunk runs
        causal attention within the chunk (the flash kernel on CUDA) and
        writes its K/V through the page table; a later chunk attends
        through the page table over everything cached so far (the
        ragged walk). The final chunk selects the request's first token
        and activates the slot."""
        cfg = self.cfg
        chunk_w = toks.shape[0]
        dev = toks.device
        idx = slot.reshape(1)
        x = T._embed(params, toks[None, :])
        ap = start + torch.arange(chunk_w, dtype=torch.int32, device=dev)
        pos = ap[None, :]
        # bucket pads and the padded tail claim no MoE expert capacity
        tok_mask = (ap < true_len)[None, :]
        pages_row = state.page_table.index_select(0, idx)[0]
        if from_zero:
            lens = true_len.reshape(1).to(torch.int32)
            within = lambda q, k, v: T._attention(cfg, q, k, v, causal=True,
                                                  key_lens=lens)
            pg, off = pa.page_addresses(pages_row, ap,
                                        page_size=self.page_size)
        for p, (k_buf, v_buf) in zip(params["blocks"], state.caches):
            if from_zero:
                x, k, v, _ = T._block_parts(cfg, p, x, pos, within, tok_mask)
                pa.write_kv_pair(k_buf, v_buf, k[0], v[0], pg, off)
            else:
                def cached(q, k, v, k_buf=k_buf, v_buf=v_buf):
                    return pa.paged_chunk_attention(
                        q, k, v, k_buf, v_buf, pages_row, start,
                        page_size=self.page_size, max_len=self.max_len,
                        impl=self.ragged_impl)[0]

                x, _, _, _ = T._block_parts(cfg, p, x, pos, cached,
                                            tok_mask)
        if final:
            x_last = x[0].index_select(0, (true_len - 1 - start).reshape(1))
            self._activate_impl(params, state, idx, x_last, true_len, temp,
                                top_k, top_p, noise, gen)

    def _activate_impl(self, params, state: EngineState, idx, x_last,
                       true_len, temp, top_k, top_p, noise, gen) -> None:
        """Select the request's first token (and its full-softmax
        logprob) from the last real prompt position's activation x_last
        [1, D] and bring the slot idx [1] live -- one definition for the
        ring prefill and every paged final chunk. noise [1, V]: the
        request's first Gumbel draw (None for a greedy request, whose
        token is the argmax; an exported chunk program always takes one,
        zeros for greedy, and the sampler's temperature 0 is the same
        argmax); gen: the request's generator, for a pool-wide
        select_fn."""
        logits = gather_full(T._head(params, x_last))
        _put(state.temp, idx, temp)
        _put(state.top_k, idx, top_k)
        _put(state.top_p, idx, top_p)
        first = self._select(logits, state.temp.index_select(0, idx),
                             state.top_k.index_select(0, idx),
                             state.top_p.index_select(0, idx), [gen], noise)
        first_lp = torch.gather(
            torch.log_softmax(at_least_f32(logits), dim=-1), 1,
            first[:, None])[:, 0]
        _put(state.pos, idx, true_len)
        _put(state.active, idx, torch.ones((), dtype=torch.bool,
                                           device=idx.device))
        _put(state.last_tok, idx, first)
        _put(state.last_lp, idx, first_lp)

    # -- ring (sliding-window) prefill -------------------------------------

    def _ring_prefill(self, state: EngineState, ticket: PrefillTicket):
        """One-shot ring-pool prefill: the bucket-padded prompt [t0]
        runs causal attention under the config's window with the real
        length as the key bound (kernel A on CUDA), and the slot's ring
        keeps the last min(true_len, W) real positions, each at slot p
        mod W: ring slot s holds p(s) = (true_len-1) - ((true_len-1 - s)
        mod W). A short prompt's negative p(s) reads a clipped row that
        the decode mask keeps invalid until it is overwritten; padded
        positions never enter the ring."""
        cfg, params, dev = self.cfg, self.params, self.device
        slot, true_len = ticket.slot, ticket.true_len
        t0 = int(ticket.prompt.shape[-1])
        x = T._embed(params, torch.as_tensor(ticket.prompt,
                                             device=dev)[None, :])
        pos = torch.arange(t0, dtype=torch.int32, device=dev)[None, :]
        lens = torch.tensor([true_len], dtype=torch.int32, device=dev)
        attn = lambda q, k, v: T._attention(cfg, q, k, v, causal=True,
                                            key_lens=lens)
        tok_mask = pos < true_len       # bucket pads claim no MoE capacity
        w = cfg.attn_window
        last = true_len - 1
        p_slot = last - np.mod(last - np.arange(w), w)
        ring_idx = torch.as_tensor(np.clip(p_slot, 0, t0 - 1), device=dev)

        def write_slot(buf, new):
            if isinstance(buf, tuple):
                nd, nsc = pa.kv_quantize(new)
                buf[0][slot] = nd
                buf[1][slot] = nsc.to(buf[1].dtype)
            else:
                buf[slot] = new.to(buf.dtype)

        for p, (k_buf, v_buf) in zip(params["blocks"], state.caches):
            x, k, v, _ = T._block_parts(cfg, p, x, pos, attn, tok_mask)
            write_slot(k_buf, k[0, ring_idx])
            write_slot(v_buf, v[0, ring_idx])
        gen = noise = None
        if ticket.temp > 0 or self.select_fn is not None:
            gen = self._request_generator(ticket.req_tag, ticket.req_seed)
            if self.select_fn is None:
                noise = sampling_ops._row_draws(1, cfg.vocab, [gen], dev,
                                                gumbel=True)
        self._activate_impl(
            params, state, _scalar(slot, torch.int64, dev).reshape(1),
            x[0, last][None], _scalar(true_len, torch.int64, dev),
            _scalar(ticket.temp, torch.float32, dev),
            _scalar(ticket.top_k, torch.int32, dev),
            _scalar(ticket.top_p, torch.float32, dev), noise, gen)
        state.generators[slot] = gen

    # -- admission (begin/advance; prefill() drives both) ------------------

    def _validate_admission(self, prompt, true_len, sampling):
        t0 = int(prompt.shape[-1])
        if true_len is None:
            true_len = t0
        elif not (1 <= true_len <= t0):
            raise ValueError(f"true_len {true_len} not in [1, {t0}]")
        if self.cfg.attn_window is None:
            # physical bounds of the full-length pool only: the ring
            # holds any prompt (it keeps the last W positions)
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
        if sampling and self.select_fn is not None:
            raise ValueError(
                "per-request sampling and a pool-wide select_fn are "
                "mutually exclusive -- drop one")
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
        if not self.paged:
            self._admissions += 1
            return state, PrefillTicket(
                slot=slot, prompt=np.asarray(prompt, np.int32),
                true_len=true_len, chunk=None, next_start=0,
                temp=float(temp),
                top_k=int(self.cfg.vocab if top_k is None else top_k),
                top_p=float(1.0 if top_p is None else top_p),
                req_tag=req_tag, req_seed=int(req_seed), windowed=True)
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
        full blocks in the prefix cache. A ring-pool ticket prefills in
        one call."""
        if ticket.windowed:
            with torch.no_grad():
                self._ring_prefill(state, ticket)
            return state, True
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

    def _sampled(self, state: EngineState) -> bool:
        """Whether a step must draw: some live slot samples (the host
        knows, so a greedy step reads nothing back from the device)."""
        return self.select_fn is None and any(
            g is not None for g in state.generators)

    def _draws(self, state: EngineState, n: int, *, gumbel: bool):
        """[S, n] draws from the slots' own generators, exactly as the
        eager sampler makes them (a greedy slot draws from a fresh
        default generator and ignores the draw)."""
        gens = [g if g is not None else torch.Generator(self.device)
                for g in state.generators]
        return sampling_ops._row_draws(self.slots, n, gens, self.device,
                                       gumbel=gumbel)

    def decode_step(self, state: EngineState):
        """Advance every active slot one token. Returns (state, emitted
        [S], emitted_lp [S], was_active [S], finished [S]): emitted[r] is
        meaningful where was_active[r]; finished rows just emitted their
        final token (eos or cache-full) -- callers still `release_slot`
        them so the host pool frees their pages. A bound "step" program
        serves an all-greedy pool, "step_sampled" (given the slots'
        Gumbel draws) any other."""
        noise = None
        if self._sampled(state):
            noise = self._draws(state, self.cfg.vocab, gumbel=True)
        if noise is None:
            out = self._run_art("step", self._raw_params, state)
        else:
            out = self._run_art("step_sampled", self._raw_params, state,
                                noise)
        if out is _MISS:
            with torch.no_grad(), self._replicated():
                out = self._step_impl(self._raw_params, state, noise)
        return (state,) + tuple(out)

    def _step_impl(self, raw_params, state: EngineState, noise=None):
        """The decode step's device work over the resident tree
        raw_params (an int8 tree is dequantized here, each step): the
        next token by argmax (noise None), by per-row sampling with the
        Gumbel draws noise [S, V], or by the pool-wide select_fn.
        Returns (emitted, emitted_lp, was_active, finished)."""
        cfg, L = self.cfg, self.max_len
        params = (_quant.dequantize_params(raw_params)
                  if _quant.has_quantized(raw_params) else raw_params)
        x = T._embed(params, state.last_tok[:, None])
        pos = state.pos[:, None]
        if not self.paged:
            # the rolling ring pool, per row: each row writes its own
            # slot (the sentinel W on inactive rows drops the write) and
            # reads the ring positions that exist
            w = cfg.attn_window
            slots_raw, ring_ok = T._ring_slot_valid(state.pos, w)
            write_slots = torch.where(state.active, slots_raw,
                                      torch.full_like(slots_raw, w))
            valid4 = (ring_ok & state.active[:, None])[:, None, None, :]
        for p, (k_buf, v_buf) in zip(params["blocks"], state.caches):
            if self.paged:
                def attn(q, k, v, k_buf=k_buf, v_buf=v_buf):
                    return pa.paged_decode_attention(
                        q, k, v, k_buf, v_buf, state.page_table,
                        state.pos, state.active,
                        page_size=self.page_size, max_len=L,
                        impl=self.ragged_impl)[0]
            else:
                def attn(q, k, v, k_buf=k_buf, v_buf=v_buf):
                    return T._cached_attention(q, k, v, k_buf, v_buf,
                                               write_slots, valid4)[0]

            # inactive slots are dead compute: no MoE capacity either
            x, _, _, _ = T._block_parts(cfg, p, x, pos, attn,
                                        state.active[:, None])
        logits = gather_full(T._head(params, x[:, -1]))
        nxt = self._select(logits, state.temp, state.top_k, state.top_p,
                           state.generators, noise)
        nxt_lp = torch.gather(
            torch.log_softmax(at_least_f32(logits), dim=-1), 1,
            nxt[:, None])[:, 0].float()
        emitted = state.last_tok.clone()
        emitted_lp = state.last_lp.clone()
        was_active = state.active.clone()
        fin = torch.zeros_like(was_active)
        if self.eos_id is not None:
            fin = was_active & (emitted == self.eos_id)
        if self.paged:
            # capacity retirement bounds the full-length pool only: the
            # ring reuses its slots, so a windowed request ends on eos
            # or the caller's max_new alone
            fin = fin | (was_active & (state.pos + 1 >= L))
        cont = was_active & ~fin
        state.pos.copy_(torch.where(cont, state.pos + 1,
                                    torch.full_like(state.pos, L)))
        state.active.copy_(cont)
        state.last_tok.copy_(nxt)
        state.last_lp.copy_(nxt_lp)
        return emitted, emitted_lp, was_active, fin

    def ensure_decode_page(self, state: EngineState,
                           slot: int) -> EngineState:
        """Advance the host page bookkeeping for one continuing slot:
        map the next write position's block when it crosses into an
        unmapped one. Raises PoolExhaustedError (position not advanced)
        when no page is available. A ring pool has nothing to map."""
        if not self.paged:
            return state
        res = self.pool.extend(slot)
        if res is not None:
            blk, page = res
            state.page_table[slot, blk] = page
        return state

    def release_slot(self, state: EngineState, slot: int) -> EngineState:
        """Retire one slot: deactivate the row, park its pos on the
        out-of-range sentinel, free its pages (refcounted) and reset its
        page-table row to the drop sentinel."""
        if self.paged and self.pool is not None:
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
        settles continuing rows with `settle_spec` after.

        A bound "spec" program (all-greedy pool) or "spec_sampled" (given
        the slots' acceptance uniforms [S, K] and Gumbel draws [S, V])
        serves a round of the bundle's width, policy.spec_draft_max."""
        dev = self.device
        d = torch.from_numpy(np.asarray(drafts, np.int64)).to(dev)
        dl = torch.from_numpy(np.asarray(draft_len, np.int64)).to(dev)
        k = d.shape[1]
        u = noise = None
        if any(g is not None for g in state.generators):
            u = self._draws(state, k, gumbel=False)
            noise = self._draws(state, self.cfg.vocab, gumbel=True)
        out = _MISS
        if k == int(self.policy.spec_draft_max):
            if u is None:
                out = self._run_art("spec", self._raw_params, state, d, dl)
            else:
                out = self._run_art("spec_sampled", self._raw_params, state,
                                    d, dl, u, noise)
        if out is _MISS:
            with torch.no_grad(), self._replicated():
                out = self._spec_impl(self._raw_params, state, d, dl, u,
                                      noise)
        return (state,) + tuple(out)

    def _spec_impl(self, raw_params, state: EngineState, d, dl, u=None,
                   noise=None):
        """The verify round's device work (drafts d [S, K], draft_len dl
        [S]); the all-greedy rule when u is None, else the sampled rule
        with the given draws. Returns (emitted, emitted_lp, n_emit,
        was_active, finished, n_accepted)."""
        cfg, L, dev = self.cfg, self.max_len, d.device
        k = d.shape[1]
        params = (_quant.dequantize_params(raw_params)
                  if _quant.has_quantized(raw_params) else raw_params)
        window = torch.cat([state.last_tok[:, None], d], dim=1)
        x = T._embed(params, window)
        pos = state.pos[:, None] + torch.arange(
            k + 1, dtype=torch.int32, device=dev)[None, :]
        # positions past a row's draft_len are padding: dead compute
        # that must not claim MoE capacity, as inactive rows
        tok_mask = state.active[:, None] & (
            torch.arange(k + 1, device=dev)[None, :] <= dl[:, None])
        for p, (k_buf, v_buf) in zip(params["blocks"], state.caches):
            # write the whole window's K/V through the table, then the
            # ragged read at per-row offsets; rejected positions are
            # rolled back on the host (pool.commit) and rewritten before
            # any later read
            def attn(q, kk, vv, k_buf=k_buf, v_buf=v_buf):
                return pa.paged_verify_attention(
                    q, kk, vv, k_buf, v_buf, state.page_table,
                    state.pos, state.active, page_size=self.page_size,
                    max_len=L, impl=self.ragged_impl)[0]

            x, _, _, _ = T._block_parts(cfg, p, x, pos, attn, tok_mask)
        logits = gather_full(T._head(params, x))            # [S, K+1, V]
        # an all-greedy pool takes the sort-free argmax rule, as the
        # plain step takes argmax; the host knows which
        if u is None:
            nxt, n_acc, lp_draft, lp_next = \
                sampling_ops.greedy_spec_verify(logits, window, dl)
        else:
            nxt, n_acc, lp_draft, lp_next = sampling_ops.ngram_spec_verify(
                logits, window, dl, state.temp, state.top_k, state.top_p,
                u=u, noise=noise)
        # a round CONSUMES window[:n_acc+1] and emits each consumed token
        # (generate()'s emit-the-carry convention per token)
        emitted = window
        emitted_lp = torch.cat([state.last_lp[:, None], lp_draft], dim=1)
        was_active = state.active.clone()
        n_con = n_acc + 1
        fin = torch.zeros_like(was_active)
        n_emit = n_con
        if self.eos_id is not None:
            # eos anywhere in the consumed prefix finishes the row at that
            # token; later accepted tokens go with the row
            is_eos = (window == self.eos_id) & (
                torch.arange(k + 1, device=dev)[None, :] < n_con[:, None])
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
        return emitted, emitted_lp, n_emit, was_active, fin, n_acc

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

    # -- KV-block migration (disaggregated prefill/decode) -----------------

    def pause_slot(self, state: EngineState, slot: int):
        """Pause one active slot at the prefill-complete seam: snapshot
        its per-row decode state to the host (one copy) and park the
        row (inactive, pos on the drop sentinel), leaving its pages
        mapped and the page table untouched. Returns (state,
        DecodeSeed); `resume_slot` continues the row exactly where it
        stopped, here or on the migration destination. Paged engines
        only."""
        vals = torch.stack([
            state.pos[slot].double(), state.last_tok[slot].double(),
            state.last_lp[slot].double(), state.temp[slot].double(),
            state.top_k[slot].double(), state.top_p[slot].double()]).cpu()
        pos, tok, lp, temp, top_k, top_p = vals.tolist()
        gen = state.generators[slot]
        key = (np.zeros((0,), np.uint8) if gen is None
               else gen.get_state().numpy().copy())
        state.active[slot] = False
        state.pos[slot] = self.max_len
        seed = DecodeSeed(pos=int(pos), last_tok=int(tok),
                          last_lp=float(np.float32(lp)),
                          temp=float(np.float32(temp)), top_k=int(top_k),
                          top_p=float(np.float32(top_p)), rng_key_data=key)
        return state, seed

    def export_slot_kv(self, state: EngineState, pages) -> list:
        """Copy the arena contents of `pages` (one slot's mapped blocks,
        in block order) to the host: per layer (k, v), each an ndarray
        [n_pages, page_size, Hkv, Dh], or an (int8 data, f32 scale)
        pair under kv_cache_dtype="int8", exported verbatim. The caller
        holds the pages (slot mapping or a pool export pin) meanwhile."""
        idx = torch.as_tensor(np.asarray(pages, np.int64),
                              device=self.device)

        def host(buf):
            if isinstance(buf, tuple):
                return tuple(b.index_select(0, idx).cpu().numpy()
                             for b in buf)
            return buf.index_select(0, idx).cpu().numpy()

        return [(host(k), host(v)) for k, v in state.caches]

    def import_slot_kv(self, state: EngineState, slot: int, pages,
                       start_block: int, kv) -> EngineState:
        """Write exported block contents into this pool's arenas for a
        freshly `import_blocks`-mapped slot and set the slot's page
        table row. Blocks before `start_block` were satisfied by this
        pool's own prefix cache (shared, read-only pages) and are not
        written: where the JAX engine scatters a padded page vector with
        a drop sentinel, this writes exactly the pages past start_block
        (an out-of-range index on CUDA is a device assert, not a no-op).
        `kv` is `export_slot_kv`'s output; its geometry must match."""
        if len(kv) != len(state.caches):
            raise ValueError(
                f"migrated KV has {len(kv)} layers, engine has "
                f"{len(state.caches)}")
        want = (self.page_size, self.cfg.kv_heads, self.cfg.head_dim)
        for k, _ in kv:
            first = k[0] if isinstance(k, tuple) else k
            if tuple(first.shape[1:]) != want:
                raise ValueError(
                    f"migrated KV block shape {tuple(first.shape[1:])} "
                    f"does not match arena {want}")
        pages = [int(p) for p in pages]
        dev = self.device
        idx = torch.as_tensor(pages[start_block:], dtype=torch.long,
                              device=dev)

        def put(buf, new):
            new = np.asarray(new)[start_block:len(pages)]
            buf[idx] = torch.as_tensor(new, device=dev).to(buf.dtype)

        if idx.numel():
            for (k_buf, v_buf), (k, v) in zip(state.caches, kv):
                for buf, new in ((k_buf, k), (v_buf, v)):
                    if isinstance(buf, tuple):
                        put(buf[0], new[0])
                        put(buf[1], new[1])
                    else:
                        put(buf, new)
        row = np.full((self.max_pages_per_slot,), self.num_pages, np.int32)
        row[:len(pages)] = pages
        state.page_table[slot] = torch.from_numpy(row).to(dev)
        return state

    def resume_slot(self, state: EngineState, slot: int,
                    seed: DecodeSeed) -> EngineState:
        """Bring a slot live from a DecodeSeed: on the migration
        destination after `import_slot_kv`, or locally after a
        cancelled handoff. The row's next decode step emits exactly the
        token the paused source row would have, and a sampled row's
        generator continues from the exported state."""
        state.pos[slot] = seed.pos
        state.active[slot] = True
        state.last_tok[slot] = seed.last_tok
        state.last_lp[slot] = seed.last_lp
        state.temp[slot] = seed.temp
        state.top_k[slot] = seed.top_k
        state.top_p[slot] = seed.top_p
        key = np.asarray(seed.rng_key_data, np.uint8)
        gen = None
        if key.size:
            gen = torch.Generator(device=self.device)
            gen.set_state(torch.from_numpy(key.copy()))
        state.generators[slot] = gen
        return state

    def kv_geometry(self) -> dict:
        """The fields two engines must agree on for a KV-block migration
        between them to be meaningful (the server's import gate): arena
        geometry, cache dtype and the paging convention. A
        tensor-parallel pool's kv_heads are one rank's (its local arena
        shard)."""
        tp = self._tp_size() if self._tp_mesh is not None else 1
        return {
            "page_size": int(self.page_size),
            "max_pages_per_slot": int(self.max_pages_per_slot),
            "kv_heads": int(self.cfg.kv_heads) // tp,
            "head_dim": int(self.cfg.head_dim),
            "kv_cache_dtype": self.cfg.kv_cache_dtype,
            "vocab": int(self.cfg.vocab),
            "max_len": int(self.max_len),
        }

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
        if buckets is not None and self.paged:
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
            if not self.paged:
                continue            # the ring holds any prompt
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
            if not self.paged:
                raise ValueError(
                    "speculative serving needs the paged engine "
                    "(sliding-window configs decode plain)")
            if self.select_fn is not None:
                raise ValueError(
                    "speculative serving composes with per-request "
                    "sampling only: a pool-wide select_fn overrides "
                    "the distribution the acceptance rule preserves")
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
        if self.pool is not None:
            pc = self.pool.counters()
            for k in ("pages_in_use", "pages_free", "peak_pages_in_use",
                      "prefix_hits", "prefix_misses", "prefill_chunks",
                      "spec_reserved", "spec_rolled_back"):
                setattr(stats, k, pc[k])
        self.last_stats = stats
        if return_logprobs:
            return toks_out, [lps[i] for i in range(len(prompts))]
        return toks_out
