"""The port's paged KV reads and writes and its ragged walk reference,
held against the live JAX package on the same inputs.

Tolerances: gathers, scatters and page addresses move values and must
be exactly equal; attention outputs are float32 sums taken in another
order by the two frameworks, so they agree to 1e-5 on unit-scale
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as JPA
from paddle_tpu.ops import ragged_paged_attention as JRPA
from paddle_tpu_torch.ops import paged_attention as PA
from paddle_tpu_torch.ops import ragged_paged_attention as RPA
from torch_parity import np_f32, to_jax, to_torch

TOL = 1e-5
PAGE, DH = 4, 8


def _case(rs, *, r, tq, h, hkv, num_pages, max_pages, sentinels=True):
    """Random arenas, a page table with sentinel entries, positions and
    an active mask with one inactive row."""
    ka = np_f32(rs, num_pages, PAGE, hkv, DH)
    va = np_f32(rs, num_pages, PAGE, hkv, DH)
    pt = rs.randint(0, num_pages, (r, max_pages)).astype(np.int32)
    if sentinels:
        pt[:, -1] = num_pages                      # unmapped tails
        pt[0, 1:] = num_pages
    q = np_f32(rs, r, tq, h, DH)
    max_len = max_pages * PAGE - 2
    pos0 = rs.randint(0, max_len - tq, (r,)).astype(np.int32)
    active = np.ones((r,), bool)
    if r > 1:
        active[-1] = False
    return dict(q=q, ka=ka, va=va, pt=pt, pos0=pos0, active=active,
                max_len=max_len)


SHAPES = [
    dict(r=5, tq=1, h=4, hkv=4, num_pages=9, max_pages=4),   # MHA decode
    dict(r=4, tq=3, h=4, hkv=2, num_pages=8, max_pages=5),   # GQA window
    dict(r=3, tq=6, h=8, hkv=2, num_pages=12, max_pages=4),  # GQA chunk
    dict(r=1, tq=7, h=2, hkv=1, num_pages=6, max_pages=6),   # MQA chunk
]


@pytest.mark.parametrize("shape", SHAPES)
def test_gather_kv_clips_sentinels_like_jax(shape):
    c = _case(np.random.RandomState(0), **shape)
    ref = JPA.gather_kv(to_jax(c["ka"]), to_jax(c["pt"]), c["max_len"],
                        jnp.float32)
    got = PA.gather_kv(to_torch(c["ka"]), to_torch(c["pt"]), c["max_len"],
                       torch.float32)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_write_kv_drops_out_of_range_pages():
    rs = np.random.RandomState(1)
    num_pages = 5
    arena = np_f32(rs, num_pages, PAGE, 2, DH)
    new = np_f32(rs, 6, 2, DH)
    # sentinel num_pages, far out of range, and in-range rows
    pages = np.array([0, num_pages, 3, num_pages + 7, 4, 1], np.int32)
    offs = np.array([1, 2, 0, 3, 3, 2], np.int32)
    ref = JPA.write_kv(to_jax(arena), to_jax(new), to_jax(pages),
                       to_jax(offs))
    t_arena = to_torch(arena)
    got = PA.write_kv(t_arena, to_torch(new), to_torch(pages),
                      to_torch(offs))
    assert got is t_arena                           # updated in place
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    # the dropped rows really left the arena untouched
    changed = np.argwhere((got.numpy() != arena).any(axis=(2, 3)))
    assert sorted(map(tuple, changed)) == [(0, 1), (1, 2), (3, 0), (4, 3)]


def test_write_kv_sentinel_leaves_last_page_alone():
    # the likely silent corruption: a clip instead of a drop would write
    # the sentinel row into the last real page
    arena = torch.zeros(3, PAGE, 1, DH)
    PA.write_kv(arena, torch.ones(2, 1, DH), torch.tensor([3, 3]),
                torch.tensor([0, 1]))
    assert arena.abs().sum() == 0


@pytest.mark.parametrize("kept_first", [True, False])
def test_write_kv_drop_never_clobbers_a_kept_write(kept_first):
    # a dropped row clips onto the very cell a kept row writes (last
    # page, offset 1); the kept value must land whatever the row order
    num_pages = 3
    arena = torch.zeros(num_pages, PAGE, 1, DH)
    new = torch.stack([torch.full((1, DH), 5.0), torch.full((1, DH), 7.0)])
    pages = torch.tensor([num_pages - 1, num_pages])
    offs = torch.tensor([1, 1])
    if not kept_first:
        new, pages, offs = new.flip(0), pages.flip(0), offs.flip(0)
    ref = JPA.write_kv(to_jax(np.zeros((num_pages, PAGE, 1, DH), np.float32)),
                       to_jax(new.numpy()), to_jax(pages.numpy()),
                       to_jax(offs.numpy()))
    PA.write_kv(arena, new, pages, offs)
    np.testing.assert_array_equal(arena.numpy(), np.asarray(ref))
    assert (arena[num_pages - 1, 1] == 5.0).all()
    # every row dropped: the arena is unchanged
    before = arena.clone()
    PA.write_kv(arena, new, torch.tensor([num_pages, 9]), offs)
    torch.testing.assert_close(arena, before, atol=0, rtol=0)


def test_page_addresses_matches_jax():
    row = np.array([7, 2, 9, 9], np.int32)
    positions = np.arange(0, 22, dtype=np.int32)
    ref = JPA.page_addresses(to_jax(row), to_jax(positions), page_size=PAGE)
    got = PA.page_addresses(to_torch(row), to_torch(positions),
                            page_size=PAGE)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_paged_decode_attention_matches_jax(shape):
    rs = np.random.RandomState(2)
    c = _case(rs, **dict(shape, tq=1))
    hkv = shape["hkv"]
    k = np_f32(rs, shape["r"], 1, hkv, DH)
    v = np_f32(rs, shape["r"], 1, hkv, DH)
    kw = dict(page_size=PAGE, max_len=c["max_len"])
    ref, rk, rv = JPA.paged_decode_attention(
        to_jax(c["q"]), to_jax(k), to_jax(v), to_jax(c["ka"]),
        to_jax(c["va"]), to_jax(c["pt"]), to_jax(c["pos0"]),
        to_jax(c["active"]), impl="jnp", **kw)
    got, gk, gv = PA.paged_decode_attention(
        to_torch(c["q"]), to_torch(k), to_torch(v), to_torch(c["ka"]),
        to_torch(c["va"]), to_torch(c["pt"]), to_torch(c["pos0"]),
        to_torch(c["active"]), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("start", [0, 5, 9])
def test_paged_chunk_attention_matches_jax(start):
    rs = np.random.RandomState(3)
    num_pages, hkv, h, c_w = 10, 2, 4, 6
    ka, va = np_f32(rs, num_pages, PAGE, hkv, DH), np_f32(
        rs, num_pages, PAGE, hkv, DH)
    row = np.array([4, 8, 1, 6, num_pages], np.int32)  # sentinel tail
    q = np_f32(rs, 1, c_w, h, DH)
    k, v = np_f32(rs, 1, c_w, hkv, DH), np_f32(rs, 1, c_w, hkv, DH)
    kw = dict(page_size=PAGE, max_len=18)
    ref, rk, rv = JPA.paged_chunk_attention(
        to_jax(q), to_jax(k), to_jax(v), to_jax(ka), to_jax(va),
        to_jax(row), start, impl="jnp", **kw)
    got, gk, gv = PA.paged_chunk_attention(
        to_torch(q), to_torch(k), to_torch(v), to_torch(ka), to_torch(va),
        to_torch(row), start, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


def test_paged_verify_attention_matches_jax():
    rs = np.random.RandomState(4)
    c = _case(rs, **dict(SHAPES[1], tq=3))
    k = np_f32(rs, 4, 3, 2, DH)
    v = np_f32(rs, 4, 3, 2, DH)
    kw = dict(page_size=PAGE, max_len=c["max_len"])
    ref, rk, rv = JPA.paged_verify_attention(
        to_jax(c["q"]), to_jax(k), to_jax(v), to_jax(c["ka"]),
        to_jax(c["va"]), to_jax(c["pt"]), to_jax(c["pos0"]),
        to_jax(c["active"]), impl="jnp", **kw)
    got, gk, gv = PA.paged_verify_attention(
        to_torch(c["q"]), to_torch(k), to_torch(v), to_torch(c["ka"]),
        to_torch(c["va"]), to_torch(c["pt"]), to_torch(c["pos0"]),
        to_torch(c["active"]), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("shape", SHAPES)
def test_ragged_reference_matches_jax_oracle_and_pallas_walk(shape):
    c = _case(np.random.RandomState(5), **shape)
    jargs = [to_jax(c[n]) for n in ("q", "ka", "va", "pt", "pos0", "active")]
    targs = [to_torch(c[n]) for n in ("q", "ka", "va", "pt", "pos0",
                                      "active")]
    kw = dict(page_size=PAGE, max_len=c["max_len"])
    oracle = np.asarray(JRPA.ragged_reference(*jargs, **kw))
    walk = np.asarray(JRPA.ragged_pallas(*jargs, interpret=True, **kw))
    got = RPA.ragged_reference(*targs, **kw).numpy()
    np.testing.assert_allclose(got, oracle, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, walk, atol=TOL, rtol=0)
    # the inactive row is the uniform mean of V over its clipped keys,
    # not zero: the finite -1e30 mask does not zero p
    if not c["active"][-1]:
        assert np.abs(got[-1]).max() > 1e-3


def test_ragged_attention_dispatch_on_cpu():
    c = _case(np.random.RandomState(6), **SHAPES[0])
    args = [to_torch(c[n]) for n in ("q", "ka", "va", "pt", "pos0",
                                     "active")]
    kw = dict(page_size=PAGE, max_len=c["max_len"])
    ref = RPA.ragged_reference(*args, **kw)
    for impl in (None, "torch"):
        torch.testing.assert_close(RPA.ragged_attention(*args, impl=impl,
                                                        **kw), ref)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        RPA.ragged_attention(*args, impl="kernel", **kw)
    with pytest.raises(ValueError, match="impl must be"):
        RPA.ragged_attention(*args, impl="pallas", **kw)

