"""Block-paged KV-cache attention: the page-table gather/scatter path
(mirror of `paddle_tpu.ops.paged_attention`).

One `[num_pages, page_size, Hkv, Dh]` arena per layer plus a static
`[S, max_pages_per_slot]` int32 page table of physical page ids per
slot. Reads gather in page-table order (= position order) and slice to
`max_len`, so the key axis is exactly a dense pool's.

int8 KV pools: an arena may be an `(s8 data [P, page, Hkv, Dh], f32
scale [P, page, Hkv])` pair -- THE per-(position, kv-head) absmax
convention (`kv_quantize`, shared with the dense caches of
`models.transformer`). Writes quantize first and scatter data and scale
with one drop plan; reads dequantize inside the gathered read
(`kv_dequantize`), and the ragged walk's kernel fuses the same element
sequence into its tile loads.

Out-of-range discipline: unmapped page-table entries and inactive rows
carry the sentinel page id `num_pages`. Reads clip it to the last page
(the values are masked by the per-row bound); writes through it are
dropped (`write_kv` implements the drop without a host sync).

Writes update the arena IN PLACE (the JAX functions return a new
arena); the functions still return the arenas so the call shapes match.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtypes import at_least_f32, sqrt_in


def num_pages_of(arena) -> int:
    """Pages of a float arena or an (s8, scale) pair."""
    return (arena[0] if isinstance(arena, tuple) else arena).shape[0]


# -- KV quantization (THE convention, shared with the dense caches) ------


def kv_quantize(x):
    """[..., T, Hkv, Dh] float -> (s8 data, f32 scale [..., T, Hkv]):
    absmax symmetric per (position, kv-head). The element sequence is
    the JAX package's: a division by the scale (not a multiply by its
    reciprocal), then round half to even, then clip."""
    xf = at_least_f32(x)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q, scale, dtype):
    """(s8 -> f32) * scale, then rounded to `dtype`."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


# -- page-table reads / writes -------------------------------------------


def gather_kv(arena, page_table, limit: int, dtype):
    """Read rows' caches through their page tables: arena [P, page,
    Hkv, Dh] or an (s8, scale) pair, page_table [R, max_pages] (entries
    clip to [0, P-1], in the data and the scale plane alike). Returns
    [R, limit, Hkv, Dh] in `dtype`, dequantized for a pair."""
    idx = page_table.long().clamp(0, num_pages_of(arena) - 1)

    def one(buf):
        g = buf[idx]                                # [R, mp, page, ...]
        r, mp, page = g.shape[:3]
        return g.reshape((r, mp * page) + tuple(g.shape[3:]))[:, :limit]

    if isinstance(arena, tuple):
        data, scale = arena
        return kv_dequantize(one(data), one(scale), dtype)
    return one(arena).to(dtype)


def _drop_plan(arena, pages, offsets):
    """Where each row of a drop-mode write goes, computed once for a K/V
    pair of arenas. Returns (pages, offsets, keep, first, any_kept).

    torch has no drop-mode scatter, and masking the kept rows out
    (`pages[keep]`) would read the mask back to the host. Instead every
    row writes, and a dropped row repeats a write that happens anyway:
    the first kept row's (same cell, same value), or -- when no row is
    kept -- its own clipped cell with the value already there. Duplicate
    writes then carry identical values, so their order cannot matter,
    and nothing leaves the device. Negative ids wrap once, as in a JAX
    scatter."""
    p, page = arena.shape[0], arena.shape[1]
    pg, off = pages.long(), offsets.long()
    pg = pg + p * (pg < 0)
    off = off + page * (off < 0)
    keep = (pg >= 0) & (pg < p) & (off >= 0) & (off < page)
    pg, off = pg.clamp(0, p - 1), off.clamp(0, page - 1)
    first = torch.argmax(keep.to(torch.int32)).reshape(1)  # or 0: none kept
    any_kept = keep.index_select(0, first)
    pg = torch.where(keep, pg,
                     torch.where(any_kept, pg.index_select(0, first), pg))
    off = torch.where(keep, off,
                      torch.where(any_kept, off.index_select(0, first), off))
    return pg, off, keep, first, any_kept


def _drop_write(arena, new, plan):
    pg, off, keep, first, any_kept = plan
    new = new.to(arena.dtype)
    # rows of data [N, Hkv, Dh] or of a scale plane [N, Hkv]
    bcast = (-1,) + (1,) * (new.ndim - 1)
    fill = torch.where(any_kept.view(bcast), new.index_select(0, first),
                       arena[pg, off])
    arena[pg, off] = torch.where(keep.view(bcast), new, fill)


def write_kv(arena, new, pages, offsets):
    """Write per-row K/V vectors in place: new [N, Hkv, Dh] at (pages
    [N], offsets [N]); an (s8, scale) pair quantizes first and scatters
    data and scale with one plan. A row whose page (or offset) is out of
    range -- the sentinel -- is dropped, as the JAX scatter's
    mode="drop" does, without a host sync (see _drop_plan). Returns the
    arena."""
    if new.shape[0]:
        _write_planned([arena], [new], pages, offsets)
    return arena


def write_kv_pair(k_arena, v_arena, k, v, pages, offsets):
    """write_kv for a K/V pair sharing one address plan (one plan for
    all four arenas of an int8 pair)."""
    _write_planned([k_arena, v_arena], [k, v], pages, offsets)


def _write_planned(arenas, news, pages, offsets):
    plan = _drop_plan(arenas[0][0] if isinstance(arenas[0], tuple)
                      else arenas[0], pages, offsets)
    for arena, new in zip(arenas, news):
        if isinstance(arena, tuple):
            nd, nsc = kv_quantize(new)
            _drop_write(arena[0], nd, plan)
            _drop_write(arena[1], nsc, plan)
        else:
            _drop_write(arena, new, plan)


# -- the shared attention body -------------------------------------------


def grouped_masked_attention(q, k_read, v_read, valid):
    """The masked grouped-head attention math (f32 scores, -1e30 mask,
    softmax in f32, output in q.dtype). q [B, Tq, H, Dh]; k_read/v_read
    [B, K, Hkv, Dh]; valid broadcastable over [B, H, Tq, K].

    The mask is finite and p is not zeroed: a row with no valid key
    returns the uniform mean of V over its K keys."""
    b, tq, h, dh = q.shape
    hkv = k_read.shape[2]
    g = h // hkv
    qg = q.reshape(b, tq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_read) / sqrt_in(
        q.dtype, dh)
    scores = at_least_f32(scores).reshape(b, h, tq, -1)
    scores = scores.masked_fill(~valid, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    wg = w.reshape(b, hkv, g, tq, -1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", wg, v_read)
    return out.reshape(b, tq, h, dh)


def page_addresses(pages_row, positions, *, page_size: int):
    """Map absolute positions -> (physical page id, within-page offset)
    through ONE slot's page-table row; the block index clips to the
    table, so sentinel entries ride through to a dropped write."""
    blk = torch.clamp(positions // page_size, 0, pages_row.shape[0] - 1)
    return pages_row[blk.long()], positions % page_size


def paged_decode_attention(q, k, v, k_arena, v_arena, page_table, pos,
                           active, *, page_size: int, max_len: int,
                           impl=None):
    """One decode step for every slot: write each row's K/V at its own
    (page, offset), then the ragged read over keys <= pos. q/k/v [S, 1,
    ., Dh]; page_table [S, max_pages]; pos [S]; active [S] bool.
    Returns (out [S, 1, H, Dh], k_arena, v_arena)."""
    s = q.shape[0]
    if q.shape[1] != 1:
        raise ValueError("decode writes are single-position")
    num_pages = num_pages_of(k_arena)
    max_pages = page_table.shape[1]
    blk = torch.clamp(pos // page_size, 0, max_pages - 1).long()
    pg = page_table[torch.arange(s, device=q.device), blk]
    # an inactive row's clipped block index must never resurrect a write
    pg = torch.where(active, pg, torch.full_like(pg, num_pages))
    off = pos % page_size
    write_kv_pair(k_arena, v_arena, k[:, 0], v[:, 0], pg, off)
    out = _ragged_read(q, k_arena, v_arena, page_table, pos, active,
                       page_size=page_size, max_len=max_len, impl=impl)
    return out, k_arena, v_arena


def paged_chunk_attention(q, k, v, k_arena, v_arena, pages_row, start,
                          *, page_size: int, max_len: int, impl=None):
    """One prefill chunk for one slot: write the chunk's K/V at
    positions start..start+C-1 through the slot's table row, then attend
    each chunk query over every cached key <= its own position (shared
    prefix pages included). q/k/v [1, C, ., Dh]; pages_row [max_pages];
    start: int. Returns (out [1, C, H, Dh], k_arena, v_arena)."""
    c = q.shape[1]
    ap = start + torch.arange(c, dtype=torch.int32, device=q.device)
    pg, off = page_addresses(pages_row, ap, page_size=page_size)
    write_kv_pair(k_arena, v_arena, k[0], v[0], pg, off)
    pos0 = torch.full((1,), int(start), dtype=torch.int32, device=q.device)
    active = torch.ones((1,), dtype=torch.bool, device=q.device)
    out = _ragged_read(q, k_arena, v_arena, pages_row[None], pos0, active,
                       page_size=page_size, max_len=max_len, impl=impl)
    return out, k_arena, v_arena


def paged_verify_attention(q, k, v, k_arena, v_arena, page_table, pos,
                           active, *, page_size: int, max_len: int,
                           impl=None):
    """The speculative verify step: write TQ consecutive positions per
    slot from its own `pos`, attend each window query over keys <= its
    position, all slots in one read. q/k/v [S, TQ, ., Dh]. Returns
    (out [S, TQ, H, Dh], k_arena, v_arena).

    A window position at or past `max_len` (padding of a row near the
    cache's end) is dropped. The JAX function clips its block index to
    the table instead, which writes such a position over the row's own
    cached keys in its last page."""
    s, tq = q.shape[0], q.shape[1]
    num_pages = num_pages_of(k_arena)
    ap = pos[:, None] + torch.arange(tq, dtype=pos.dtype,
                                     device=q.device)[None, :]
    blk = torch.clamp(ap // page_size, 0, page_table.shape[1] - 1).long()
    pg = torch.gather(page_table, 1, blk)
    off = ap % page_size
    keep = active[:, None] & (ap < max_len)
    pg = torch.where(keep, pg, torch.full_like(pg, num_pages))
    rows = lambda x: x.reshape((s * tq,) + tuple(x.shape[2:]))
    write_kv_pair(k_arena, v_arena, rows(k), rows(v), pg.reshape(-1),
                  off.reshape(-1))
    out = _ragged_read(q, k_arena, v_arena, page_table, pos, active,
                       page_size=page_size, max_len=max_len, impl=impl)
    return out, k_arena, v_arena


def _ragged_read(q, k_arena, v_arena, page_table, pos0, active, *,
                 page_size: int, max_len: int, impl=None):
    """The shared read+attend tail: the ragged page-table walk
    (ops.ragged_paged_attention), kernel on CUDA tensors."""
    from paddle_tpu_torch.ops import ragged_paged_attention as _rpa

    return _rpa.ragged_attention(q, k_arena, v_arena, page_table, pos0,
                                 active, page_size=page_size,
                                 max_len=max_len, impl=impl)
