"""Kernels B and C's split walk (`csrc/ragged_paged_attention.cu
split_walk_kernel`), its schedule written out in PyTorch: the walk of
each query tile split over runs of whole pages (whole tiles of a page
larger than a split), each split's keys dealt to the block's key groups
tile by tile, every group's f32 partial (m, l, acc) under the finite
-1e30 mask, merged in the kernel's order (groups, then splits). Held
against the port's plain version, the JAX oracle and the JAX walk in
interpret mode -- over int8 arenas (C) and over float arenas in f32 and
bf16 (B) -- at several split counts, and the host's split plan
(`walk_plan`) pinned at the serving shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as JPA
from paddle_tpu.ops import ragged_paged_attention as JRPA
from paddle_tpu_torch.core.dtypes import at_least_f32, sqrt_in
from paddle_tpu_torch.ops import paged_attention as PA
from paddle_tpu_torch.ops import ragged_paged_attention as RPA
from torch_parity import np_f32, to_jax, to_torch

PAGE, DH = 4, 16
MASK = -1e30
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _np(x):
    return np.asarray(jax.device_get(x))


def _partial(s, v):
    """(m, l, acc) of scores s [n] and values v [n, Dh]: the online
    softmax from m = -1e30, l = 0 (no key: l = 0 and acc = 0)."""
    m = torch.maximum(s.max(), torch.tensor(MASK)) if len(s) else \
        torch.tensor(MASK)
    p = torch.exp(s - m)
    return m, p.sum(), p @ v


def _merge(parts):
    """The partials merged in order: M = max m, L = sum l e^(m - M), A =
    sum acc e^(m - M)."""
    mm = torch.tensor(MASK)
    for m, _, _ in parts:
        mm = torch.maximum(mm, m)
    l, a = 0.0, 0.0
    for m, lp, ap in parts:
        f = torch.exp(m - mm)
        l, a = l + lp * f, a + ap * f
    return mm, l, a


def split_walk_schedule(q, k_arena, v_arena, page_table, pos0, active, *,
                        page_size, max_len, plan):
    """The split walk's function computed in its schedule for `plan`."""
    r_n, tq, h, dh = q.shape
    k = PA.gather_kv(k_arena, page_table, max_len, q.dtype)
    v = PA.gather_kv(v_arena, page_table, max_len, q.dtype).float()
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(r_n, tq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / sqrt_in(q.dtype, dh)
    scores = at_least_f32(scores).reshape(r_n, h, tq, max_len)
    ap = pos0[:, None].long() + torch.arange(tq)[None, :]
    valid = (torch.arange(max_len)[None, None, :] <= ap[:, :, None]) & \
        active[:, None, None]
    scores = scores.masked_fill(~valid[:, None], MASK)
    rows_pb, span = plan.rows_per_block, plan.span
    kg = 16 // (rows_pb * g)
    out = torch.empty((r_n, tq, h, dh))
    for r in range(r_n):
        for qt in range(plan.q_tiles):
            i0 = qt * rows_pb
            last = min(i0 + rows_pb, tq) - 1
            bound = int(pos0[r]) + last + 1
            kend = bound if bool(active[r]) and 0 < bound < max_len \
                else max_len
            for i in range(i0, last + 1):
                for hh in range(h):
                    splits = []
                    for sp in range(plan.splits):
                        lo = sp * span
                        keys = np.arange(lo, max(lo, min(lo + span, kend)))
                        groups = [keys[((keys - lo) % 32) % kg == grp]
                                  for grp in range(kg)]
                        splits.append(_merge([
                            _partial(scores[r, hh, i, ks],
                                     v[r, ks, hh // g]) for ks in groups]))
                    _, l, a = _merge(splits)
                    out[r, i, hh] = a / l
    return out.to(q.dtype)


# rows, TQ, heads, KV heads, pages, max_pages, max_len, pos0, active, q
# dtype, sentinel table tails
CASES = {
    "decode": dict(r=5, tq=1, h=4, hkv=4, pages=24, mp=10, max_len=40,
                   pos0=[0, 7, 20, 39, 33]),
    "decode_bf16": dict(r=4, tq=1, h=4, hkv=4, pages=24, mp=10, max_len=40,
                        pos0=[3, 38, 39, 16], dtype="bfloat16"),
    "inactive_rows": dict(r=4, tq=1, h=2, hkv=2, pages=20, mp=10,
                          max_len=37, pos0=[5, 30, 12, 36],
                          active=[True, False, True, False]),
    "sentinels": dict(r=3, tq=2, h=4, hkv=2, pages=16, mp=10, max_len=40,
                      pos0=[4, 17, 38], sentinel_tail=5),
    "gqa_g8": dict(r=2, tq=3, h=8, hkv=1, pages=16, mp=9, max_len=33,
                   pos0=[9, 30]),
    "gqa_g4_bf16": dict(r=3, tq=2, h=8, hkv=2, pages=16, mp=10,
                        max_len=40, pos0=[0, 21, 37], dtype="bfloat16",
                        active=[True, True, False]),
    "prefix_chunk": dict(r=1, tq=20, h=2, hkv=2, pages=12, mp=10,
                         max_len=40, pos0=[12]),
    "verify_window": dict(r=3, tq=5, h=4, hkv=4, pages=16, mp=10,
                          max_len=40, pos0=[2, 19, 35],
                          active=[True, False, True]),
}


# kernel B: float arenas in q's dtype; page and head_dim where they
# differ from PAGE and DH (head_dim 128; a page larger than the most keys
# one split walks, so that splits run over whole tiles of a page)
FLOAT_CASES = {
    "decode": dict(r=5, tq=1, h=4, hkv=4, pages=24, mp=10, max_len=40,
                   pos0=[0, 7, 20, 39, 33]),
    "decode_bf16": dict(r=4, tq=1, h=4, hkv=4, pages=24, mp=10,
                        max_len=40, pos0=[3, 38, 39, 16], dtype="bfloat16"),
    "inactive_rows": dict(r=4, tq=1, h=2, hkv=2, pages=20, mp=10,
                          max_len=37, pos0=[5, 30, 12, 36],
                          active=[True, False, True, False]),
    "inactive_rows_bf16": dict(r=3, tq=1, h=2, hkv=2, pages=20, mp=10,
                               max_len=37, pos0=[36, 30, 2],
                               active=[True, True, False],
                               dtype="bfloat16"),
    "sentinels_tq2": dict(r=3, tq=2, h=4, hkv=2, pages=16, mp=10,
                          max_len=40, pos0=[4, 17, 38], sentinel_tail=5),
    "gqa_h8_hkv2": dict(r=3, tq=2, h=8, hkv=2, pages=16, mp=10,
                        max_len=40, pos0=[0, 21, 37],
                        active=[True, True, False]),
    "gqa_h8_hkv2_bf16": dict(r=3, tq=2, h=8, hkv=2, pages=16, mp=10,
                             max_len=40, pos0=[0, 21, 37],
                             dtype="bfloat16", active=[True, True, False]),
    "head_dim128": dict(r=2, tq=3, h=4, hkv=2, pages=12, mp=9,
                        max_len=33, pos0=[9, 30], dh=128),
    "head_dim128_bf16": dict(r=2, tq=1, h=4, hkv=4, pages=12, mp=9,
                             max_len=33, pos0=[32, 11], dh=128,
                             dtype="bfloat16"),
    "prefix_chunk": dict(r=1, tq=20, h=2, hkv=2, pages=12, mp=10,
                         max_len=40, pos0=[12]),
    "verify_window_bf16": dict(r=3, tq=5, h=4, hkv=4, pages=16, mp=10,
                               max_len=40, pos0=[2, 19, 35],
                               active=[True, False, True],
                               dtype="bfloat16"),
    "page_544_keys": dict(r=2, tq=2, h=2, hkv=2, pages=3, mp=3,
                          max_len=1100, pos0=[700, 1098], page=544, dh=8,
                          active=[True, True]),
}


def _case(name, seed=0, float_kv=False):
    """A case's (spec, torch arguments, JAX arguments): int8 (s8, scale)
    arenas quantized by the JAX package, or (float_kv) float arenas in
    q's dtype."""
    z = (FLOAT_CASES if float_kv else CASES)[name]
    rs = np.random.RandomState(seed)
    dh = z.get("dh", DH)
    shape = (z["pages"], z.get("page", PAGE), z["hkv"], dh)
    dtype = z.get("dtype", "float32")
    if float_kv:
        ka, va = np_f32(rs, *shape), np_f32(rs, *shape)
        jk, jv = (jnp.asarray(a, jnp.dtype(dtype)) for a in (ka, va))
        tk, tv = (to_torch(a).to(getattr(torch, dtype)) for a in (ka, va))
    else:
        pair = lambda: JPA.kv_quantize(to_jax(np_f32(rs, *shape)))
        jk, jv = pair(), pair()
        tpair = lambda p: (to_torch(_np(p[0])), to_torch(_np(p[1])))
        tk, tv = tpair(jk), tpair(jv)
    pt = rs.randint(0, z["pages"], (z["r"], z["mp"])).astype(np.int32)
    if z.get("sentinel_tail"):
        pt[:, -z["sentinel_tail"]:] = z["pages"]
    q = np_f32(rs, z["r"], z["tq"], z["h"], dh)
    pos0 = np.asarray(z["pos0"], np.int32)
    active = np.asarray(z.get("active", [True] * z["r"]))
    targs = (to_torch(q).to(getattr(torch, dtype)), tk, tv,
             to_torch(pt), to_torch(pos0), to_torch(active))
    jargs = (jnp.asarray(q, jnp.dtype(dtype)), jk, jv, to_jax(pt),
             to_jax(pos0), to_jax(active))
    return z, targs, jargs


def _plans(z):
    """The walk's plans for the case at several SM counts (one split up
    to a page or a tile per split), and, where a block takes it, one
    split of the whole walk and splits of three pages."""
    page = z.get("page", PAGE)
    shape = (z["r"], z["tq"], z["h"], z["hkv"], z["max_len"], page)
    plans = {RPA.walk_plan(*shape, sms) for sms in (1, 8, 132)}
    base = RPA.walk_plan(*shape, 1)
    for span in (-(-z["max_len"] // page) * page, 3 * page):
        if span <= RPA.MAX_SPAN_KEYS:
            plans.add(base._replace(splits=-(-z["max_len"] // span),
                                    span=span))
    return sorted(plans)


def _held_against_reference_and_jax(z, targs, jargs):
    """The schedule at every plan of `_plans` against the port's plain
    version, the JAX oracle and the JAX walk in interpret mode. Returns
    the last schedule's output (f32 numpy)."""
    kw = dict(page_size=z.get("page", PAGE), max_len=z["max_len"])
    ref = RPA.ragged_reference(*targs, **kw).float()
    oracle = _np(JRPA.ragged_reference(*jargs, **kw).astype(jnp.float32))
    walk = _np(JRPA.ragged_pallas(*jargs, interpret=True,
                                  **kw).astype(jnp.float32))
    tol = TOL[targs[0].dtype]
    plans = _plans(z)
    assert len({p.splits for p in plans}) >= 3
    for plan in plans:
        assert plan.span <= RPA.MAX_SPAN_KEYS
        got = split_walk_schedule(*targs, plan=plan, **kw)
        assert got.dtype == targs[0].dtype
        got = got.float().numpy()
        for want in (ref.numpy(), oracle, walk):
            np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    if not z.get("active", [True])[-1]:     # uniform mean of V, not zero
        assert np.abs(got[-1]).max() > 1e-3
    return got


@pytest.mark.parametrize("name", list(CASES))
def test_split_walk_schedule_matches_reference_and_jax(name):
    _held_against_reference_and_jax(*_case(name))


@pytest.mark.parametrize("name", list(FLOAT_CASES))
def test_float_split_walk_schedule_matches_reference_and_jax(name):
    """Kernel B: the same schedule over float arenas in q's dtype (the
    float tile loader reads raw tiles, nothing per key), against the
    plain version, the JAX oracle and the JAX float walk in interpret
    mode; f32 to 1e-5, bf16 to 2e-2."""
    z, targs, jargs = _case(name, float_kv=True)
    _held_against_reference_and_jax(z, targs, jargs)
    if z.get("page", PAGE) > RPA.MAX_SPAN_KEYS:
        # every plan splits inside a page; the largest split is 512 keys
        assert all(p.span < z["page"] for p in _plans(z))


def test_splits_with_no_live_key_add_nothing():
    """A split wholly past an active row's last position walks no key and
    leaves l = 0: the row's output is the one-split walk's, whatever
    the split count; an inactive row's splits all keep m = -1e30 and
    merge to the uniform mean of V over max_len keys."""
    z, targs, _ = _case("inactive_rows", seed=1)
    kw = dict(page_size=PAGE, max_len=z["max_len"])
    pages = -(-z["max_len"] // PAGE)
    one = RPA.WalkPlan(1, 1, 1, pages * PAGE)
    many = RPA.WalkPlan(1, 1, pages, PAGE)
    a = split_walk_schedule(*targs, plan=one, **kw)
    b = split_walk_schedule(*targs, plan=many, **kw)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    v = PA.gather_kv(targs[2], targs[3], z["max_len"], torch.float32)
    torch.testing.assert_close(b[1, 0], v[1].mean(0), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape,want", [
    # (rows, TQ, H, Hkv, max_len, page) -> (rows per block, query tiles,
    # splits, keys per split, blocks); kernels B and C share the plan.
    # Main decode: 8 rows x 8 KV heads, 16 pages of 16: one 32-key tile
    # per split, 8 splits, 512 blocks
    ((8, 1, 8, 8, 256, 16), (1, 1, 8, 32, 512)),
    # the prefix chunk TQ=64: 4 query tiles of 16, a page per split
    ((1, 64, 8, 8, 256, 16), (16, 4, 16, 16, 512)),
    # verify windows TQ=5: 5 query rows a block, 3 key groups
    ((8, 5, 8, 8, 256, 16), (5, 1, 8, 32, 512)),
    # GQA, 4 query heads per KV head
    ((8, 4, 8, 2, 256, 16), (4, 1, 16, 16, 256)),
    # 64 rows fill the card alone: one split
    ((64, 1, 8, 8, 256, 16), (1, 1, 1, 256, 512)),
    # a long walk: 24 pages (384 keys, 12 tiles) a split
    ((8, 1, 8, 8, 2048, 16), (1, 1, 6, 384, 384)),
    # at most 512 keys a block
    ((64, 1, 8, 8, 4096, 16), (1, 1, 8, 512, 4096)),
    # B's prefix chunk TQ=100 in the chip smoke: 7 query tiles, two pages
    # (one tile) per split
    ((1, 100, 8, 8, 256, 16), (16, 7, 8, 32, 448)),
    # pages of 1024 keys, larger than a split: 12 tiles a split
    ((8, 1, 8, 8, 2048, 1024), (1, 1, 6, 384, 384)),
])
def test_walk_plan_fills_the_card(shape, want):
    rows, tq, heads, kv_heads, max_len, page = shape
    plan = RPA.walk_plan(*shape, 132)
    assert tuple(plan) + (plan.blocks(rows, kv_heads),) == want
    # every key of the walk lies in a split, a split is whole pages (whole
    # tiles where a page holds more than MAX_SPAN_KEYS keys) of at most
    # MAX_SPAN_KEYS keys, and a block's query vectors fit its 16 slots
    unit = page if page <= RPA.MAX_SPAN_KEYS else RPA.TILE_KEYS
    assert (plan.splits - 1) * plan.span < max_len <= plan.splits * plan.span
    assert plan.span % unit == 0 and plan.span <= RPA.MAX_SPAN_KEYS
    assert plan.rows_per_block * (heads // kv_heads) <= 16
    assert (plan.q_tiles - 1) * plan.rows_per_block < tq
    # 2 x 132 blocks or more, unless every split is one page (or one
    # tile of a large page) already
    assert plan.blocks(rows, kv_heads) >= 264 or plan.span == unit
