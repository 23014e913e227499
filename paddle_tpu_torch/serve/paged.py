"""Host-side page allocator + shared-prefix cache for the paged KV pool.

The device side (ops.paged_attention) reads and writes through a
static `[S, max_pages_per_slot]` page table; THIS module owns which
physical pages back which slot, entirely on the host at admit/extend/
retire time — no device sync in the allocator, the engine pushes table
rows to the device only when a mapping actually changes (admission,
one page per `page_size` decoded tokens, retire).

Capacity model: a slot holding a sequence of current length L maps
`L // page_size + 1` pages (blocks covering positions 0..L — the +1 is
the block the NEXT decode token writes into). Pool memory therefore
follows the SUM of actual lengths, not slots x max_len: that is the
whole throughput case for paging, and `ServingServer` admits against
`headroom()` instead of free-slot count.

Shared-prefix reuse (copy-free): the prefix cache maps a CHAINED block
key — (parent_key, the block's page_size token ids) — to the physical
page holding that block's K/V. Only FULL blocks that a finished
prefill wrote are registered, and a consumer may share at most the
blocks strictly before the block containing its own last prompt token
(so every admission computes >= 1 position — the first-token logits
must come from a real forward). Shared pages are READ-ONLY by
construction: decode writes land at positions >= true_len, which is
past every shared block, so "copy-on-write" resolves at admission time
— a prompt diverging inside block b simply takes a fresh page for b
(the CoW split) while blocks [0, b) stay shared. Refcounts track
holders (each slot + the cache itself); a page frees when its count
hits zero.

Exhaustion discipline: `alloc` first reclaims LRU cache-only pages
(refcount 1 — no live slot) and only then raises PoolExhaustedError —
the signal `ServingServer` turns into shed/requeue and
`DecodeEngine.serve` into preempt-or-capacity-retire. Entry validation
rejects a prompt whose own blocks exceed the whole pool up front.

Corruption defense: every cache entry stores its block's token ids and
`lookup` re-verifies them against the prompt before sharing — a
corrupted entry (testing.faults `serve_prefix_corrupt_at`) degrades to
a miss and is evicted instead of silently serving another prompt's
K/V.

`reconcile()` asserts the page-accounting invariant the chaos harness
checks after every burst: allocated == in-use + free, every held page
refcounted >= 1, per-page refcount == its holder count.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple


def blocks_for(true_len: int, page_size: int) -> int:
    """Pages a sequence of prompt length `true_len` maps at admission:
    blocks covering positions 0..true_len (the +1 is the block the
    first decode token writes into). THE single definition of the
    admission-block convention — the allocator and every up-front
    capacity validation (engine prefill/serve, server submit) route
    here so the rule cannot drift between them."""
    return true_len // page_size + 1


def shareable_blocks(true_len: int, page_size: int) -> int:
    """Leading FULL blocks a prompt of `true_len` may consume from a
    prefix cache: strictly before the block holding its last prompt
    token, so >= 1 position always prefills (the first-token logits
    need a real forward). Module-level twin of the pool method, shared
    with the router's affinity-key derivation."""
    return (true_len - 1) // page_size


def chain_keys(tokens, true_len: int, page_size: int,
               n_blocks: Optional[int] = None) -> List[tuple]:
    """The prompt's CHAINED block keys, shallowest first: key[b] =
    (key[b-1], block b's page_size token ids), key[-1] = (). THE one
    derivation of the prefix-cache key — `PagePool`'s lookup/register
    and the fleet router's affinity map (serve.router) both call it,
    so "a request whose prefix is hot on replica k" is decided by
    exactly the hash the replica's own cache would hit. Default depth
    is the CONSUMER bound (`shareable_blocks`); register passes the
    publisher bound (every full block) explicitly."""
    if n_blocks is None:
        n_blocks = shareable_blocks(true_len, page_size)
    keys: List[tuple] = []
    key: tuple = ()
    for b in range(n_blocks):
        key = (key, tuple(int(t)
                          for t in tokens[b * page_size:
                                          (b + 1) * page_size]))
        keys.append(key)
    return keys


class PoolExhaustedError(RuntimeError):
    """No free page and nothing reclaimable — the paged pool's
    backpressure signal. Transient by nature (pages free as co-tenant
    requests finish): the server requeues/sheds on it, the plain
    serve() loop preempts a co-tenant or capacity-retires."""


@dataclasses.dataclass
class _CacheEntry:
    """One registered prefix block: `tokens` is the ground truth the
    lookup re-verifies (corruption defense), `key` its chained cache
    key (kept for eviction bookkeeping)."""

    page: int
    tokens: Tuple[int, ...]
    key: tuple


class PagePool:
    """Allocator + prefix cache for one engine pool generation (a new
    `init_state()` makes a fresh one, like the admission counter)."""

    def __init__(self, *, num_pages: int, page_size: int, slots: int,
                 max_pages_per_slot: int, prefix_cache: bool = True,
                 prefix_cache_blocks: int = 512):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.slots = slots
        self.max_pages_per_slot = max_pages_per_slot
        self.sentinel = num_pages          # the drop page id
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refcount = [0] * num_pages
        self.slot_pages: List[List[int]] = [[] for _ in range(slots)]
        self.slot_shared = [0] * slots     # leading cache-hit pages
        self.slot_pos: List[Optional[int]] = [None] * slots
        self.prefix_cache_enabled = prefix_cache
        self.prefix_cache_blocks = prefix_cache_blocks
        self._cache: "collections.OrderedDict[tuple, _CacheEntry]" = \
            collections.OrderedDict()
        # counters (PoolStats observability satellite)
        self.prefix_hits = 0        # admissions reusing >= 1 block
        self.prefix_misses = 0      # admissions reusing none
        self.prefix_rejected = 0    # corrupted entries refused+evicted
        self.prefill_chunks = 0     # jitted chunk invocations
        self.peak_pages_in_use = 0
        # speculative-decoding page traffic (reserve/commit below)
        self.spec_reserved = 0      # pages pre-mapped for verify windows
        self.spec_rolled_back = 0   # reserved pages returned on rejection
        # KV-block migration (disaggregated prefill/decode)
        self._exports: Dict[int, List[int]] = {}   # export id -> pinned pages
        self._next_export = 0
        self.migrated_out_pages = 0  # pages pinned for an outbound transfer
        self.migrated_in_pages = 0   # freshly allocated pages on import
        # testing.faults seam: fault_hook(event, ctx) — "alloc" may
        # return truthy to force PoolExhaustedError, "lookup" may
        # mutate the _CacheEntry it is handed
        self.fault_hook: Optional[Callable] = None
        # paddle_tpu.obs seam: obs_hook(event, ctx) fires AFTER an
        # admit/release mutates the books (never before — observers
        # must see settled state, and a raising hook must not be able
        # to half-apply an admission). ServingServer attaches page
        # events to the owning request's span through it. Host-side
        # only; exceptions are swallowed.
        self.obs_hook: Optional[Callable] = None

    # -- gauges ------------------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    def evictable(self) -> int:
        """Cache-only pages (refcount 1): reclaimable on demand."""
        return sum(1 for e in self._cache.values()
                   if self._refcount[e.page] == 1)

    def headroom(self) -> int:
        """Pages an allocation could obtain right now."""
        return len(self._free) + self.evictable()

    def blocks_for(self, true_len: int) -> int:
        """`blocks_for(true_len, self.page_size)` — see the module
        function (the single admission-block convention)."""
        return blocks_for(true_len, self.page_size)

    def _hook(self, event: str, ctx=None):
        if self.fault_hook is not None:
            return self.fault_hook(event, ctx)
        return None

    def _obs(self, event: str, **ctx) -> None:
        if self.obs_hook is None:
            return
        try:
            self.obs_hook(event, ctx)
        except Exception:
            pass        # telemetry never takes the pool down

    # -- allocation --------------------------------------------------------

    def _reclaim(self, n: int) -> None:
        """Evict LRU cache-only entries until `n` pages are free (or
        nothing reclaimable remains)."""
        if len(self._free) >= n:
            return
        for key in list(self._cache):
            if len(self._free) >= n:
                break
            entry = self._cache[key]
            if self._refcount[entry.page] == 1:
                del self._cache[key]
                self._decref(entry.page)

    def alloc(self, n: int) -> List[int]:
        """Take `n` pages (refcount 1 each), reclaiming cache-only
        pages as needed; raises PoolExhaustedError leaving the pool
        untouched when short."""
        if n == 0:
            return []
        if self._hook("alloc", n):
            raise PoolExhaustedError(
                "injected page-pool exhaustion (fault plan)")
        self._reclaim(n)
        if len(self._free) < n:
            raise PoolExhaustedError(
                f"page pool exhausted: need {n} pages, "
                f"{len(self._free)} free of {self.num_pages} "
                f"({len(self._cache)} cached blocks, "
                f"{self.evictable()} evictable)")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refcount[p] = 1
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)
        return pages

    def _decref(self, page: int) -> None:
        self._refcount[page] -= 1
        assert self._refcount[page] >= 0, (page, self._refcount[page])
        if self._refcount[page] == 0:
            self._free.append(page)

    # -- the prefix cache --------------------------------------------------

    def shareable_blocks(self, true_len: int) -> int:
        """`shareable_blocks(true_len, self.page_size)` — see the
        module function (the single consumer-bound convention)."""
        return shareable_blocks(true_len, self.page_size)

    def lookup(self, tokens, true_len: int) -> List[int]:
        """Longest chain of cached leading blocks for this prompt
        (pages in block order, NOT yet refcounted — `admit` takes the
        references). Re-verifies each entry's stored tokens; a
        mismatch (corruption) evicts the entry and stops the chain."""
        pages: List[int] = []
        if not self.prefix_cache_enabled:
            return pages
        for key in chain_keys(tokens, true_len, self.page_size):
            blk = key[1]
            entry = self._cache.get(key)
            if entry is None:
                break
            self._hook("lookup", entry)
            if entry.tokens != blk:
                # corrupted entry: refuse it, evict it, count it
                del self._cache[key]
                self._decref(entry.page)
                self.prefix_rejected += 1
                break
            self._cache.move_to_end(key)      # LRU touch
            pages.append(entry.page)
        return pages

    def register(self, slot: int, tokens, true_len: int) -> None:
        """Publish the slot's finished-prefill FULL blocks (end <=
        true_len) into the cache; the cache takes one reference per
        newly registered page. Blocks the slot itself shared are
        already present (touched, not re-referenced)."""
        if not self.prefix_cache_enabled:
            return
        n_full = true_len // self.page_size
        keys = chain_keys(tokens, true_len, self.page_size,
                          n_blocks=min(n_full,
                                       len(self.slot_pages[slot])))
        for b, key in enumerate(keys):
            blk = key[1]
            if key in self._cache:
                self._cache.move_to_end(key)
                continue
            page = self.slot_pages[slot][b]
            self._cache[key] = _CacheEntry(page=page, tokens=blk,
                                           key=key)
            self._refcount[page] += 1
        # bounded cache: shed LRU entries past capacity
        while len(self._cache) > self.prefix_cache_blocks:
            _, old = self._cache.popitem(last=False)
            self._decref(old.page)

    # -- slot lifecycle ----------------------------------------------------

    def _probe_chain(self, tokens, true_len: int) -> List[int]:
        """The cached leading-block chain for this prompt as a PURE
        probe: no LRU touch, no eviction, no fault hook — the server
        re-asks on every loop iteration for a deferred queue head, so
        probing must not perturb allocator state; `admit()`'s real
        `lookup` does all of that exactly once."""
        pages: List[int] = []
        if self.prefix_cache_enabled:
            for key in chain_keys(tokens, true_len, self.page_size):
                entry = self._cache.get(key)
                if entry is None or entry.tokens != key[1]:
                    break
                pages.append(entry.page)
        return pages

    def pages_needed(self, tokens, true_len: int) -> int:
        """Admission cost AFTER prefix reuse (pure probe)."""
        return self.blocks_for(true_len) - len(
            self._probe_chain(tokens, true_len))

    def admissible(self, tokens, true_len: int) -> bool:
        """Can `admit()` succeed RIGHT NOW? The server's admission
        gate. NOT `pages_needed() <= headroom()`: admit refs the
        request's own shared prefix pages before allocating (the
        anti-aliasing order), so cache-only pages in its OWN chain are
        not reclaimable for this allocation — counting them (as
        headroom() does) would admit a request whose admit() then
        raises a spurious PoolExhaustedError and burns retry budget.
        Pure probe, like pages_needed."""
        shared = set(self._probe_chain(tokens, true_len))
        need = self.blocks_for(true_len) - len(shared)
        avail = len(self._free) + sum(
            1 for e in self._cache.values()
            if self._refcount[e.page] == 1 and e.page not in shared)
        return need <= avail

    def admit(self, slot: int, tokens, true_len: int
              ) -> Tuple[List[int], int]:
        """Map a slot for a prompt: share cached leading blocks
        (refcount++) and allocate the rest. Returns (the slot's full
        page list, shared_len in tokens). Raises PoolExhaustedError
        with the pool untouched when the private part cannot be
        allocated."""
        assert not self.slot_pages[slot], (
            f"slot {slot} still holds pages — release before admit")
        shared = self.lookup(tokens, true_len)
        total = self.blocks_for(true_len)
        # take the shared references BEFORE allocating: a cache-only
        # page (refcount 1) is reclaimable, and alloc's reclaim must
        # not be able to evict-and-hand-back a page this admission is
        # about to read — that aliased one page as two blocks of one
        # slot and let the prefill overwrite published prefix content
        for p in shared:
            self._refcount[p] += 1
        try:
            fresh = self.alloc(total - len(shared))
        except PoolExhaustedError:
            for p in shared:
                self._decref(p)       # cache ref remains: rc >= 1
            raise
        self.slot_pages[slot] = shared + fresh
        assert len(set(self.slot_pages[slot])) == total, (
            "page aliased across blocks", slot, self.slot_pages[slot])
        self.slot_shared[slot] = len(shared)
        self.slot_pos[slot] = true_len
        if shared:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        self._obs("page_admit", slot=slot, pages=total,
                  shared=len(shared), free=self.pages_free)
        return list(self.slot_pages[slot]), len(shared) * self.page_size

    def extend(self, slot: int) -> Optional[Tuple[int, int]]:
        """Advance the slot's write position one token; when it
        crosses into an unmapped block, allocate that block's page and
        return (block_index, page) for the device table update (None
        when no new mapping is needed). On PoolExhaustedError the
        position does NOT advance — the caller may free a victim and
        retry."""
        pos = self.slot_pos[slot]
        assert pos is not None, f"slot {slot} not admitted"
        new_pos = pos + 1
        blk = new_pos // self.page_size
        out = None
        if blk >= len(self.slot_pages[slot]):
            if blk >= self.max_pages_per_slot:
                # physical max_len bound — the engine retires the row
                # before ever writing there; nothing to map
                self.slot_pos[slot] = new_pos
                return None
            page = self.alloc(1)[0]               # may raise: pos kept
            self.slot_pages[slot].append(page)
            out = (blk, page)
        self.slot_pos[slot] = new_pos
        return out

    def reserve(self, slot: int, k: int) -> List[Tuple[int, int]]:
        """Pre-map every block the speculative verify window needs —
        positions slot_pos..slot_pos+k get written in ONE launch, so
        their blocks must be mapped BEFORE it, unlike extend()'s
        one-position-at-a-time walk. Does NOT advance the position
        (commit() does, once the host knows how much was accepted).
        Returns the new (block_index, page) mappings for the device
        table. All-or-nothing: on PoolExhaustedError the pool is
        untouched (alloc's own atomicity) — the caller degrades the
        slot to a draft-free round or preempts, its choice.
        reserve(slot, 0) is a no-op by construction: commit() always
        leaves the current write position's block mapped."""
        pos = self.slot_pos[slot]
        assert pos is not None, f"slot {slot} not admitted"
        last_blk = min((pos + k) // self.page_size,
                       self.max_pages_per_slot - 1)
        mapped = len(self.slot_pages[slot])
        need = last_blk + 1 - mapped
        if need <= 0:
            return []
        pages = self.alloc(need)                  # may raise: untouched
        out = list(zip(range(mapped, mapped + need), pages))
        self.slot_pages[slot].extend(pages)
        self.spec_reserved += need
        self._obs("page_reserve", slot=slot, pages=need,
                  free=self.pages_free)
        return out

    def commit(self, slot: int, consumed: int
               ) -> Tuple[List[Tuple[int, int]], List[int]]:
        """Settle a speculative round: advance the slot `consumed`
        positions (the accepted window) and ROLL BACK reserved blocks
        the new position doesn't cover — the rejected suffix's pages
        go back through the same refcount machinery every release
        uses, so a rolled-back page a co-tenant or the prefix cache
        still holds simply drops one reference. Returns (new_mappings,
        dropped_block_indices): the former when full acceptance pushed
        the next write position into a fresh block (the one alloc this
        can need — on PoolExhaustedError the position does NOT advance
        and nothing changed, mirroring extend()'s retry contract), the
        latter for the engine to re-sentinel on the device table.
        Callers only commit CONTINUING rows (finished rows release),
        so the new position is always within the physical bound."""
        pos = self.slot_pos[slot]
        assert pos is not None, f"slot {slot} not admitted"
        new_pos = pos + consumed
        keep = new_pos // self.page_size + 1
        assert keep <= self.max_pages_per_slot, (slot, new_pos)
        mapped = len(self.slot_pages[slot])
        added: List[Tuple[int, int]] = []
        dropped: List[int] = []
        if keep > mapped:
            # full acceptance crossed past the reserve window into a
            # fresh block; the rollback tail is empty by construction,
            # so this alloc is the only mutation — a raise leaves the
            # pool untouched for the caller's preempt-and-retry
            assert keep == mapped + 1, (slot, keep, mapped)
            page = self.alloc(1)[0]               # may raise: pos kept
            self.slot_pages[slot].append(page)
            added = [(mapped, page)]
        elif keep < mapped:
            for blk in range(keep, mapped):
                self._decref(self.slot_pages[slot][blk])
                dropped.append(blk)
            del self.slot_pages[slot][keep:]
            self.spec_rolled_back += len(dropped)
        self.slot_pos[slot] = new_pos
        if dropped:
            self._obs("page_rollback", slot=slot, pages=len(dropped),
                      free=self.pages_free)
        return added, dropped

    # -- KV-block migration (disaggregated prefill/decode) -----------------

    def export_blocks(self, slot: int) -> Tuple[int, List[int]]:
        """Pin the slot's mapped pages for an outbound KV transfer:
        each page takes one extra reference under a fresh export id, so
        the physical pages stay valid — not freed, not recycled into
        another slot — for as long as the transfer is in flight, even
        if the source slot itself releases meanwhile (deadline expiry,
        preemption, or the post-ACK handoff release). THE refcount
        discipline the migration fault model leans on: a destination
        dying mid-transfer costs nothing, the source copy is still
        whole until `release_export` (which the orchestrator calls only
        after the destination ACKs or the request is re-routed).
        Returns (export_id, the slot's pages in block order)."""
        pages = list(self.slot_pages[slot])
        assert pages, f"slot {slot} holds no pages to export"
        eid = self._next_export
        self._next_export += 1
        for p in pages:
            self._refcount[p] += 1
        self._exports[eid] = pages
        self.migrated_out_pages += len(pages)
        self._obs("page_export", slot=slot, pages=len(pages),
                  export_id=eid)
        return eid, pages

    def release_export(self, export_id: int) -> None:
        """Drop an export's pins (destination ACKed, or the transfer
        was abandoned); pages with no other holder free as usual."""
        pages = self._exports.pop(export_id)
        for p in pages:
            self._decref(p)
        self._obs("page_export_release", export_id=export_id,
                  pages=len(pages), free=self.pages_free)

    @property
    def exports_outstanding(self) -> int:
        return len(self._exports)

    def export_ids(self) -> List[int]:
        """The outstanding export pins' ids — the cross-ledger seam
        `ServingServer.reconcile` joins against its parked handoffs
        (and, through them, the shared-memory arena's live tickets):
        every pin must belong to a parked transfer, on all ledgers."""
        return list(self._exports)

    def import_blocks(self, slot: int, tokens, true_len: int
                      ) -> Tuple[List[int], int]:
        """Map a slot for a MIGRATED finished prefill. Identical
        alloc/refcount semantics to `admit` — cached leading blocks
        under the same `chain_keys` derivation are shared (the inbound
        copy of those blocks is redundant and the engine skips writing
        them), the rest allocate fresh. Returns (the slot's full page
        list, shared_blocks): the engine writes arena contents only
        for blocks >= shared_blocks, then `register` publishes the
        full blocks so the migrated prefix seeds THIS pool's cache.
        Raises PoolExhaustedError with the pool untouched (admit's
        atomicity) — the transfer orchestrator picks another
        destination or retries later; the source pins are unaffected."""
        pages, shared_len = self.admit(slot, tokens, true_len)
        shared_blocks = shared_len // self.page_size
        self.migrated_in_pages += len(pages) - shared_blocks
        self._obs("page_import", slot=slot, pages=len(pages),
                  shared=shared_blocks, free=self.pages_free)
        return pages, shared_blocks

    def release(self, slot: int) -> None:
        """Drop the slot's references; pages with no other holder
        (no co-tenant share, not cached) return to the free list.
        Idempotent — retiring an already-empty slot is a no-op."""
        released = len(self.slot_pages[slot])
        for p in self.slot_pages[slot]:
            self._decref(p)
        self.slot_pages[slot] = []
        self.slot_shared[slot] = 0
        self.slot_pos[slot] = None
        if released:
            self._obs("page_release", slot=slot, pages=released,
                      free=self.pages_free)

    # -- accounting --------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        return {
            "pages_in_use": self.pages_in_use,
            "pages_free": self.pages_free,
            "peak_pages_in_use": self.peak_pages_in_use,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_rejected": self.prefix_rejected,
            "prefill_chunks": self.prefill_chunks,
            "spec_reserved": self.spec_reserved,
            "spec_rolled_back": self.spec_rolled_back,
            "migrated_out_pages": self.migrated_out_pages,
            "migrated_in_pages": self.migrated_in_pages,
        }

    def reconcile(self) -> None:
        """Assert the page-accounting invariant (chaos-harness
        contract): allocated = in-use + free, every page referenced by
        a slot or the cache carries refcount >= 1, and each page's
        refcount equals its holder count exactly — no leak, no double
        free, no aliased ownership."""
        holders = [0] * self.num_pages
        for pages in self.slot_pages:
            assert len(set(pages)) == len(pages), (
                "slot maps one page twice", pages)
            for p in pages:
                holders[p] += 1
        for entry in self._cache.values():
            holders[entry.page] += 1
        for pages in self._exports.values():
            for p in pages:
                holders[p] += 1
        free = set(self._free)
        assert len(free) == len(self._free), "free list duplicates"
        assert self.pages_in_use + self.pages_free == self.num_pages
        for p in range(self.num_pages):
            assert self._refcount[p] == holders[p], (
                f"page {p}: refcount {self._refcount[p]} != "
                f"{holders[p]} holders")
            if holders[p] > 0:
                assert p not in free, f"page {p} held AND free"
            else:
                assert p in free, f"page {p} leaked (no holder, not free)"
