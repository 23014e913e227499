"""The port's int8 serving held against the live JAX package: the KV
quantization convention, int8 (s8, scale) arenas through the paged
writes, gathers and the ragged walk's plain version, weight-only int8
params, and int8 engines and decodes on the same weights.

Tolerances: quantized data, scatters and gathers move or round values
by the same element sequence on both sides and must be exactly equal
(a scale within 1e-7 relative, f32 rounding of one division); attention
outputs are float32 sums in another order, 1e-5 (bf16: 2e-2, one bf16
rounding of unit-scale values); greedy tokens are equal and
log-probabilities within 1e-4, as for the float engine."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import pytree as JPT
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import paged_attention as JPA
from paddle_tpu.ops import ragged_paged_attention as JRPA
from paddle_tpu.serve import quant as JQ
from paddle_tpu.serve.engine import DecodeEngine as JEngine
from paddle_tpu_torch.core import pytree as TPT
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.weights import params_from_numpy, \
    params_to_numpy
from paddle_tpu_torch.ops import paged_attention as PA
from paddle_tpu_torch.ops import ragged_paged_attention as RPA
from paddle_tpu_torch.serve import quant as TQ
from paddle_tpu_torch.serve.engine import DecodeEngine
from torch_parity import make_models, np_f32, to_jax, to_torch

PAGE, HKV, DH = 4, 2, 8
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
CFG = dict(vocab=96, dim=32, n_layers=2, n_heads=4)


def _np(x):
    return np.asarray(jax.device_get(x))


def _quant_input(rs, n):
    """[n, HKV, DH] values with the edge cases of the quantizer: an
    all-zero vector and one far below the 1e-8 floor (both take the
    floor), and one whose quotients land on .5 (round half to even)."""
    x = np_f32(rs, n, HKV, DH) * 3
    x[0, 0] = 0.0
    x[1, 1] *= 1e-12
    x[2, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 62.5, 63.5]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_matches_jax(dtype):
    x = _quant_input(np.random.RandomState(0), 7)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = to_torch(x).to(getattr(torch, dtype))
    jd, js = JPA.kv_quantize(jx)
    td, ts = PA.kv_quantize(tx)
    assert td.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=1e-7, atol=0)
    # the floor, and half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 63.5 -> 64
    assert (ts[0, 0] == np.float32(1e-8) / np.float32(127.0)).item()
    np.testing.assert_array_equal(td[2, 0].numpy(),
                                  [127, 0, 2, 2, 0, -2, 62, 64])
    back = PA.kv_dequantize(td, ts, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), _np(JPA.kv_dequantize(jd, js, jnp.float32)))


def _arenas(rs, num_pages):
    """(s8, scale) K and V arenas quantized from standard normals, as
    both packages hold them."""
    shape = (num_pages, PAGE, HKV, DH)
    pair = lambda: JPA.kv_quantize(to_jax(np_f32(rs, *shape)))
    jk, jv = pair(), pair()
    tpair = lambda p: (to_torch(_np(p[0])), to_torch(_np(p[1])))
    return jk, jv, tpair(jk), tpair(jv)


def _assert_pairs_equal(t_arena, j_arena):
    for t, j in zip(t_arena, j_arena):
        np.testing.assert_array_equal(t.numpy(), _np(j))


def test_write_kv_pair_on_int8_arenas_drops_sentinels_like_jax():
    rs = np.random.RandomState(1)
    num_pages = 5
    jk, jv, tk, tv = _arenas(rs, num_pages)
    k, v = _quant_input(rs, 6), np_f32(rs, 6, HKV, DH)
    # in range, the sentinel, far out of range, and a sentinel row that
    # clips onto a kept row's cell (last page, offset 3)
    pages = np.array([0, num_pages, 3, num_pages + 7, 4, num_pages],
                     np.int32)
    offs = np.array([1, 2, 0, 3, 3, 3], np.int32)
    ref_k = JPA.write_kv(jk, to_jax(k), to_jax(pages), to_jax(offs))
    ref_v = JPA.write_kv(jv, to_jax(v), to_jax(pages), to_jax(offs))
    PA.write_kv_pair(tk, tv, to_torch(k), to_torch(v), to_torch(pages),
                     to_torch(offs))
    _assert_pairs_equal(tk, ref_k)
    _assert_pairs_equal(tv, ref_v)
    # the single-arena form on a pair, every row dropped: unchanged
    before = [t.clone() for t in tk]
    out = PA.write_kv(tk, to_torch(k[:2]), torch.tensor([num_pages, 9]),
                      torch.tensor([0, 1]))
    assert out is tk
    for a, b in zip(tk, before):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_kv_on_int8_arenas_matches_jax(dtype):
    rs = np.random.RandomState(2)
    jk, _, tk, _ = _arenas(rs, 6)
    pt = rs.randint(0, 6, (3, 4)).astype(np.int32)
    pt[0, 2:] = 6                     # sentinels clip in data and scale
    ref = JPA.gather_kv(jk, to_jax(pt), 13, getattr(jnp, dtype))
    got = PA.gather_kv(tk, to_torch(pt), 13, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  _np(ref.astype(jnp.float32)))


# the JAX int8 walk's shape zoo (tests/test_ragged_int8.py): rows, TQ,
# pages, max_len, pos0, active, q dtype; table sentinels per case
ZOO = {
    "decode": dict(r=5, tq=1, pages=9, mp=4, max_len=14,
                   pos0=[0, 3, 7, 13, 5]),
    "page_crossing": dict(r=4, tq=3, pages=8, mp=4, max_len=16,
                          pos0=[PAGE - 1, PAGE - 2, 2 * PAGE - 1, 0]),
    "mixed_chunk_decode_verify": dict(
        r=4, tq=4, pages=12, mp=5, max_len=19, pos0=[6, 0, 15, 19],
        active=[True, True, True, False]),
    "sentinel_inactive": dict(r=3, tq=1, pages=6, mp=4, max_len=12,
                              pos0=[5, 9, 21], active=[True, True, False],
                              sentinels=True),
    "bf16": dict(r=3, tq=2, pages=6, mp=3, max_len=11, pos0=[0, 4, 8],
                 dtype="bfloat16"),
    "max_len_not_page_multiple": dict(r=3, tq=1, pages=7, mp=3, max_len=10,
                                      pos0=[0, 5, 9]),
    "gqa_h8": dict(r=2, tq=2, pages=6, mp=4, max_len=16, pos0=[3, 11],
                   h=8),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_ragged_reference_on_int8_arenas_matches_jax_oracle_and_walk(name):
    z = ZOO[name]
    rs = np.random.RandomState(3)
    jk, jv, tk, tv = _arenas(rs, z["pages"])
    pt = rs.randint(0, z["pages"], (z["r"], z["mp"])).astype(np.int32)
    if z.get("sentinels"):
        pt[0, 2:] = z["pages"]
        pt[2, :] = z["pages"]
    q = np_f32(rs, z["r"], z["tq"], z.get("h", 4), DH)
    pos0 = np.asarray(z["pos0"], np.int32)
    active = np.asarray(z.get("active", [True] * z["r"]))
    jdt = getattr(jnp, z.get("dtype", "float32"))
    tdt = getattr(torch, z.get("dtype", "float32"))
    jargs = (jnp.asarray(q, jdt), jk, jv, to_jax(pt), to_jax(pos0),
             to_jax(active))
    kw = dict(page_size=PAGE, max_len=z["max_len"])
    oracle = _np(JRPA.ragged_reference(*jargs, **kw).astype(jnp.float32))
    walk = _np(JRPA.ragged_pallas(*jargs, interpret=True,
                                  **kw).astype(jnp.float32))
    got = RPA.ragged_attention(to_torch(q).to(tdt), tk, tv, to_torch(pt),
                               to_torch(pos0), to_torch(active), **kw)
    assert got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_allclose(got, oracle, atol=TOL[tdt], rtol=0)
    np.testing.assert_allclose(got, walk, atol=TOL[tdt], rtol=0)
    if not active[-1]:      # uniform mean of V, not zero
        assert np.abs(got[-1]).max() > 1e-3


def test_int8_pairs_take_the_kernel_or_raise_on_cpu():
    rs = np.random.RandomState(4)
    _, _, tk, tv = _arenas(rs, 4)
    args = (to_torch(np_f32(rs, 2, 1, 4, DH)), tk, tv,
            torch.zeros((2, 3), dtype=torch.int32),
            torch.tensor([1, 5], dtype=torch.int32),
            torch.ones(2, dtype=torch.bool))
    kw = dict(page_size=PAGE, max_len=10)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        RPA.ragged_attention(*args, impl="kernel", **kw)
    torch.testing.assert_close(RPA.ragged_attention(*args, **kw),
                               RPA.ragged_reference(*args, **kw))
    assert set(RPA.launch_counts) == {"tq1", "tqn", "int8_tq1", "int8_tqn"}


@pytest.mark.parametrize("op", ["decode", "verify", "chunk"])
def test_paged_writers_on_int8_arenas_match_jax(op):
    rs = np.random.RandomState(5)
    num_pages, r, h = 10, 3, 4
    jk, jv, tk, tv = _arenas(rs, num_pages)
    tq = {"decode": 1, "verify": 3, "chunk": 5}[op]
    if op == "chunk":
        r = 1
    pt = rs.randint(0, num_pages, (r, 5)).astype(np.int32)
    pt[:, -1] = num_pages
    q = np_f32(rs, r, tq, h, DH)
    k, v = np_f32(rs, r, tq, HKV, DH), np_f32(rs, r, tq, HKV, DH)
    pos = np.array([2, 9, 13][:r], np.int32)
    active = np.array([True, False, True][:r])
    kw = dict(page_size=PAGE, max_len=18)
    jq, jkk, jvv = to_jax(q), to_jax(k), to_jax(v)
    tqq, tkk, tvv = to_torch(q), to_torch(k), to_torch(v)
    if op == "chunk":
        ref, rk, rv = JPA.paged_chunk_attention(
            jq, jkk, jvv, jk, jv, to_jax(pt[0]), 5, impl="jnp", **kw)
        got, gk, gv = PA.paged_chunk_attention(
            tqq, tkk, tvv, tk, tv, to_torch(pt[0]), 5, **kw)
    else:
        fn = {"decode": "paged_decode_attention",
              "verify": "paged_verify_attention"}[op]
        ref, rk, rv = getattr(JPA, fn)(
            jq, jkk, jvv, jk, jv, to_jax(pt), to_jax(pos), to_jax(active),
            impl="jnp", **kw)
        got, gk, gv = getattr(PA, fn)(
            tqq, tkk, tvv, tk, tv, to_torch(pt), to_torch(pos),
            to_torch(active), **kw)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5, rtol=0)
    _assert_pairs_equal(gk, rk)
    _assert_pairs_equal(gv, rv)


def test_verify_tq1_is_decode_on_int8_arenas():
    rs = np.random.RandomState(6)
    _, _, tk, tv = _arenas(rs, 9)
    tk2, tv2 = tuple(t.clone() for t in tk), tuple(t.clone() for t in tv)
    pt = to_torch(rs.randint(0, 9, (4, 4)).astype(np.int32))
    q, k, v = (to_torch(np_f32(rs, 4, 1, hh, DH)) for hh in (4, HKV, HKV))
    pos = torch.tensor([0, 5, 9, 30], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    kw = dict(page_size=PAGE, max_len=14)
    out_d = PA.paged_decode_attention(q, k, v, tk, tv, pt, pos, active,
                                      **kw)[0]
    out_v = PA.paged_verify_attention(q, k, v, tk2, tv2, pt, pos, active,
                                      **kw)[0]
    torch.testing.assert_close(out_d, out_v, atol=0, rtol=0)
    for a, b in zip(tk + tv, tk2 + tv2):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# -- weight-only int8 ----------------------------------------------------


class _Models(tuple):
    """make_models' tuple, hashable by identity (the engine cache key)."""

    __hash__ = object.__hash__
    __eq__ = object.__eq__


@pytest.fixture(scope="module")
def models():
    return _Models(make_models(seed=0, **CFG))


def test_tree_names_match_jax(models):
    _, _, jp, tp = models
    j_names, t_names = [], []
    JPT.tree_map_with_name(lambda n, l: j_names.append(n), jp)
    TPT.tree_map_with_name(lambda n, l: t_names.append(n), tp)
    assert sorted(j_names) == sorted(t_names)
    assert "blocks/1/qkv/kernel" in t_names
    assert len(TPT.tree_leaves(tp)) == len(jax.tree.leaves(jp))


@pytest.mark.parametrize("match", [JQ.DEFAULT_MATCH, None, r"fc\d"])
def test_quantize_params_matches_jax(models, match):
    _, _, jp, tp = models
    jq = jax.device_get(JQ.quantize_params(jp, match=match))
    tq = TQ.quantize_params(tp, match=match)
    j_leaves, t_leaves = {}, {}
    JPT.tree_map_with_name(lambda n, l: j_leaves.setdefault(n, l), jq)
    # the JAX tree holds QuantizedTensor nodes: key the port's by the
    # same names (name/q, name/scale)
    for name, leaf in _flat_names(tq):
        t_leaves[name] = leaf
    assert sorted(j_leaves) == sorted(t_leaves)
    n_quant = 0
    for name, ref in j_leaves.items():
        got = t_leaves[name]
        if name.endswith("/q"):
            n_quant += 1
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-7, atol=0,
                                       err_msg=name)
    # 4 kernels per block + lm_head; None adds the embedding table
    assert n_quant == {JQ.DEFAULT_MATCH: 9, None: 10, r"fc\d": 4}[match]
    assert TQ.has_quantized(tq) and not TQ.has_quantized(tp)


def _flat_names(tree):
    out = []

    def fn(name, leaf):
        if isinstance(leaf, TQ.QuantizedTensor):
            out.extend([(name + "/q", leaf.q), (name + "/scale", leaf.scale)])
        else:
            out.append((name, leaf))

    TPT.tree_map_with_name(fn, tree)
    return out


def test_dequantize_params_and_error_match_jax(models):
    _, _, jp, tp = models
    jq = JQ.quantize_params(jp)
    tq = TQ.quantize_params(tp)
    ref = jax.device_get(JQ.dequantize_params(jq))
    got = params_to_numpy(TQ.dequantize_params(tq))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref),
                                 jax.tree_util.tree_leaves_with_path(got)):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=str(path))
    err = TQ.quantization_error(tp, tq)
    assert 0 < err < 0.05
    assert abs(err - JQ.quantization_error(jp, jq)) < 1e-6


def test_weight_bridge_carries_quantized_leaves(models):
    _, _, jp, tp = models
    jq = jax.device_get(JQ.quantize_params(jp))
    carried = params_from_numpy(jq, device="cpu")
    mine = TQ.quantize_params(tp)
    for (na, a), (nb, b) in zip(_flat_names(carried), _flat_names(mine)):
        assert na == nb and a.dtype == b.dtype, na
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    back = params_to_numpy(carried)
    leaf = back["blocks"][0]["fc1"]["kernel"]
    assert isinstance(leaf, TQ.QuantizedTensor)
    np.testing.assert_array_equal(leaf.q, jq["blocks"][0]["fc1"]["kernel"].q)
    # bf16 floats, the int8 leaves keep their types
    bf = params_from_numpy(jq, device="cpu", dtype=torch.bfloat16)
    qt = bf["lm_head"]["kernel"]
    assert (qt.q.dtype, qt.scale.dtype) == (torch.int8, torch.float32)


# -- the dense caches and generate() ------------------------------------


def test_cached_attention_int8_matches_jax():
    rs = np.random.RandomState(7)
    b, total, h = 2, 9, 4
    k_buf = JPA.kv_quantize(to_jax(np_f32(rs, b, total, HKV, DH)))
    v_buf = JPA.kv_quantize(to_jax(np_f32(rs, b, total, HKV, DH)))
    q, k, v = (np_f32(rs, b, 2, hh, DH) for hh in (h, HKV, HKV))
    valid = (np.arange(total) <= 6)[None, None, None, :]
    ref, rk, rv = JT._cached_attention(to_jax(q), to_jax(k), to_jax(v),
                                       k_buf, v_buf, 5, to_jax(valid))
    tk = tuple(to_torch(_np(x)) for x in k_buf)
    tv = tuple(to_torch(_np(x)) for x in v_buf)
    got, gk, gv = TT._cached_attention(to_torch(q), to_torch(k),
                                       to_torch(v), tk, tv, 5,
                                       to_torch(valid))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5, rtol=0)
    _assert_pairs_equal(gk, rk)
    _assert_pairs_equal(gv, rv)


@pytest.fixture(scope="module")
def int8_models():
    return _Models(make_models(seed=0, kv_cache_dtype="int8", **CFG))


@pytest.mark.parametrize("ragged", [False, True])
def test_generate_int8_kv_matches_jax(int8_models, ragged):
    jcfg, tcfg, jp, tp = int8_models
    prompt = np.random.RandomState(8).randint(0, 96, (2, 7)).astype(np.int32)
    lens = np.array([7, 4], np.int32)
    kw_j = dict(prompt_lens=to_jax(lens)) if ragged else {}
    kw_t = dict(prompt_lens=to_torch(lens)) if ragged else {}
    ref = _np(JT.generate(jp, jcfg, to_jax(prompt), 9, **kw_j))
    got = TT.generate(tp, tcfg, to_torch(prompt), 9, **kw_t).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(set(ref[:, 7:].ravel().tolist())) > 2
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        TT.generate(tp, dataclasses.replace(tcfg, kv_cache_dtype="fp8"),
                    to_torch(prompt), 3)


def test_generate_int8_weights_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    prompt = np.random.RandomState(9).randint(0, 96, (2, 6)).astype(np.int32)
    jq = JQ.quantize_params(jp)
    ref = _np(JT.generate(jq, jcfg, to_jax(prompt), 9))
    got = TT.generate(TQ.quantize_params(tp), tcfg, to_torch(prompt),
                      9).numpy()
    np.testing.assert_array_equal(got, ref)


# -- the engine ----------------------------------------------------------


def _prompts(seed, n=5, shared=8):
    """Half the prompts share a `shared`-token prefix (prefix hits)."""
    rs = np.random.RandomState(seed)
    pre = rs.randint(0, CFG["vocab"], shared)
    out = []
    for i in range(n):
        tail = rs.randint(0, CFG["vocab"], 2 + 2 * i)
        out.append(np.concatenate([pre, tail]).astype(np.int32) if i % 2 == 0
                   else rs.randint(0, CFG["vocab"], 5 + i).astype(np.int32))
    return out


@functools.lru_cache(maxsize=None)
def _jax_engine(models, int8_weights, geometry):
    """One JAX engine per (weights, pool geometry): serve() starts from a
    fresh pool each call and reuses the engine's compiled bodies."""
    jcfg, _, jp, _ = models
    if int8_weights:
        jp = JQ.quantize_params(jp)
    return JEngine(jp, jcfg, **dict(geometry))


def _serve_both(models, prompts, *, max_new, engine_kw,
                int8_weights=False):
    """Serve on both engines (tokens, log-probs) from one bucket length,
    which keeps the JAX engine to two prefill compiles."""
    _, tcfg, _, tp = models
    if int8_weights:
        tp = TQ.quantize_params(tp)
    j_eng = _jax_engine(models, int8_weights,
                        tuple(sorted(engine_kw.items())))
    t_eng = DecodeEngine(tp, tcfg, device="cpu", **engine_kw)
    kw = dict(max_new=max_new, buckets=(24,), return_logprobs=True)
    ref = j_eng.serve(prompts, **kw)
    got = t_eng.serve(prompts, **kw)
    assert got[0] == ref[0]
    np.testing.assert_allclose(np.concatenate(got[1]),
                               np.concatenate(ref[1]), atol=1e-4, rtol=0)
    assert len({t for r in got[0] for t in r}) > 3       # tokens vary
    return j_eng.last_stats, t_eng.last_stats


TIGHT = dict(slots=3, max_len=40, page_size=PAGE, num_pages=12,
             prefill_chunk=8)


def test_int8_kv_engine_matches_jax_with_prefix_hits(int8_models):
    js, ts = _serve_both(int8_models, _prompts(0), max_new=7,
                         engine_kw=dict(slots=2, max_len=40, page_size=PAGE))
    assert ts.prefix_hits == js.prefix_hits > 0


def test_int8_kv_engine_matches_jax_oversubscribed_chunked(int8_models):
    js, ts = _serve_both(int8_models, _prompts(2, n=6), max_new=10,
                         engine_kw=TIGHT)
    assert ts.retried == js.retried > 0
    assert ts.prefill_chunks == js.prefill_chunks


def test_int8_weight_engine_matches_jax(models):
    js, ts = _serve_both(models, _prompts(1), max_new=7,
                         engine_kw=dict(slots=2, max_len=40, page_size=PAGE),
                         int8_weights=True)
    assert ts.prefix_hits == js.prefix_hits > 0


def test_int8_engine_state_and_validation(int8_models):
    _, tcfg, _, tp = int8_models
    eng = DecodeEngine(tp, tcfg, slots=2, max_len=16, page_size=PAGE,
                       device="cpu")
    data, scale = eng.init_state().caches[0][0]
    assert data.dtype == torch.int8 and data.shape == (8, PAGE, 4, 8)
    assert scale.dtype == torch.float32 and scale.shape == (8, PAGE, 4)
    # not zero: zeros quantize to data 0 with the eps-floor scale
    assert (scale == np.float32(1e-8 / 127.0)).all()
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        DecodeEngine(tp, dataclasses.replace(tcfg, kv_cache_dtype="fp8"),
                     slots=1, max_len=16, device="cpu")
    # an engine with int8 weights prefills from the dequantized tree and
    # dequantizes the same numbers again for each step
    qp = TQ.quantize_params(tp)
    q_eng = DecodeEngine(qp, tcfg, slots=1, max_len=16, device="cpu")
    assert not TQ.has_quantized(q_eng.params)
    for tree in (q_eng.params, q_eng._step_params()):
        torch.testing.assert_close(
            tree["lm_head"]["kernel"],
            TQ.dequantize_tensor(qp["lm_head"]["kernel"]), atol=0, rtol=0)
