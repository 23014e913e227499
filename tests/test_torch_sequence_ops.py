"""The port's sequence ops (`paddle_tpu_torch.ops.sequence`) against the
JAX package's on the same seeded inputs: the packed segment ops (an
empty segment and padding ids past the sentinel included), pack/unpack,
the nested (2-level) ops, `context_projection` and `sequence_conv` with
and without trainable padding (values and gradients), and
`kmax_seq_score` (ties, rows shorter than k). Tolerance f32 1e-5; kmax
positions exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sequence as JSQ
from paddle_tpu_torch.ops import sequence as TSQ
from torch_parity import assert_tree_close, np_f32, to_jax, to_torch

TOL = 1e-5
NSEG = 4
# packed batch: seq 0 len 3, seq 1 empty, seq 2 len 4, seq 3 len 2, and
# four padding slots -- the sentinel id NSEG and ids past it (JAX drops
# those; the port sends them to its sentinel row)
SEG = np.asarray([0, 0, 0, 2, 2, 2, 2, 3, 3, NSEG, NSEG, 7, 9], np.int32)
POS = np.asarray([0, 1, 2, 0, 1, 2, 3, 0, 1, 0, 0, 0, 0], np.int32)
LENS = np.asarray([3, 0, 4, 2], np.int32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max(initial=0.0) <= tol, \
        np.abs(got - want).max()


def _tokens(seed=0, feat=(3,)):
    return np_f32(np.random.RandomState(seed), len(SEG), *feat)


@pytest.mark.parametrize("op", ["sequence_sum", "sequence_mean",
                                "sequence_sqrt_pool", "sequence_max"])
@pytest.mark.parametrize("feat", [(3,), (2, 3)], ids=["2d", "3d"])
def test_segment_pools_match_jax_with_an_empty_segment(op, feat):
    x = _tokens(1, feat)
    want = getattr(JSQ, op)(to_jax(x), to_jax(SEG), NSEG)
    got = getattr(TSQ, op)(to_torch(x), to_torch(SEG), NSEG)
    _close(got, want)
    assert np.all(got[1].numpy() == 0.0)              # the empty segment


@pytest.mark.parametrize("op", ["sequence_sum", "sequence_max",
                                "sequence_mean"])
def test_segment_pool_gradients_match_jax(op):
    x = _tokens(2)
    w = np_f32(np.random.RandomState(3), NSEG, 3)
    jg = jax.grad(lambda a: jnp.sum(getattr(JSQ, op)(a, to_jax(SEG), NSEG)
                                    * to_jax(w)))(to_jax(x))
    tx = to_torch(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(
        torch.sum(getattr(TSQ, op)(tx, to_torch(SEG), NSEG) * to_torch(w)),
        tx)
    _close(tg, jg)


def test_first_last_softmax_expand_match_jax():
    x = _tokens(4)
    jx, tx = to_jax(x), to_torch(x)
    js, ts = to_jax(SEG), to_torch(SEG)
    jp, tp = to_jax(POS), to_torch(POS)
    _close(TSQ.sequence_first(tx, ts, tp, NSEG),
           JSQ.sequence_first(jx, js, jp, NSEG))
    _close(TSQ.sequence_last(tx, ts, tp, to_torch(LENS), NSEG),
           JSQ.sequence_last(jx, js, jp, to_jax(LENS), NSEG))
    scores = x[:, 0]
    _close(TSQ.sequence_softmax(to_torch(scores), ts, NSEG),
           JSQ.sequence_softmax(to_jax(scores), js, NSEG))
    rows = np_f32(np.random.RandomState(5), NSEG, 2)
    _close(TSQ.sequence_expand(to_torch(rows), ts, NSEG),
           JSQ.sequence_expand(to_jax(rows), js, NSEG))
    mask = SEG < NSEG
    _close(TSQ.masked_positions(tx, to_torch(mask), fill=-2.0),
           JSQ.masked_positions(jx, to_jax(mask), fill=-2.0))


def test_sequence_softmax_gradient_matches_jax():
    scores = _tokens(6)[:, 0]
    w = np_f32(np.random.RandomState(7), len(SEG))
    jg = jax.grad(lambda a: jnp.sum(JSQ.sequence_softmax(
        a, to_jax(SEG), NSEG) * to_jax(w)))(to_jax(scores))
    ts = to_torch(scores).requires_grad_(True)
    (tg,) = torch.autograd.grad(torch.sum(TSQ.sequence_softmax(
        ts, to_torch(SEG), NSEG) * to_torch(w)), ts)
    _close(tg, jg)


@pytest.mark.parametrize("max_len", [4, 3], ids=["fits", "cut"])
def test_pack_to_dense_and_back_match_jax(max_len):
    x = _tokens(8, (2,))
    jd, jm = JSQ.pack_to_dense(to_jax(x), to_jax(SEG), to_jax(POS), NSEG,
                               max_len)
    td, tm = TSQ.pack_to_dense(to_torch(x), to_torch(SEG), to_torch(POS),
                               NSEG, max_len)
    _close(td, jd)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(TSQ.dense_to_pack(td, to_torch(SEG), to_torch(POS), NSEG),
           JSQ.dense_to_pack(jd, to_jax(SEG), to_jax(POS), NSEG))


# nested: inner 0, 1 -> outer 0; inner 2, 4 -> outer 2; inner 3 empty;
# outer 1 has no sub-sequence; the last two slots are padding
N_INNER, N_OUTER = 5, 3
INNER = np.asarray([0, 0, 1, 2, 2, 2, 4, 5, 5], np.int32)
OUTER = np.asarray([0, 0, 0, 2, 2, 2, 2, 3, 3], np.int32)


def test_outer_of_inner_map_matches_jax():
    want = JSQ.outer_of_inner_map(to_jax(INNER), to_jax(OUTER), N_INNER)
    got = TSQ.outer_of_inner_map(to_torch(INNER), to_torch(OUTER), N_INNER)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0, 0, 2, 4, 2]           # inner 3 -> sentinel


@pytest.mark.parametrize("outer_mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("inner_mode", ["sum", "mean", "max", "sqrt"])
def test_nested_pool_matches_jax(inner_mode, outer_mode):
    x = np_f32(np.random.RandomState(9), len(INNER), 3)
    ooi = np.asarray(JSQ.outer_of_inner_map(to_jax(INNER), to_jax(OUTER),
                                            N_INNER))
    want = JSQ.nested_pool(to_jax(x), to_jax(INNER), to_jax(ooi), N_INNER,
                           N_OUTER, inner_mode=inner_mode,
                           outer_mode=outer_mode)
    got = TSQ.nested_pool(to_torch(x), to_torch(INNER), to_torch(ooi),
                          N_INNER, N_OUTER, inner_mode=inner_mode,
                          outer_mode=outer_mode)
    want = np.asarray(want)
    # an empty outer sequence's max is -inf in both packages
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    _close(got.numpy()[fin], want[fin])


def test_expand_and_first_subseq_match_jax():
    ooi = np.asarray([0, 0, 2, 4, 2], np.int32)       # 4: a sentinel
    vals = np_f32(np.random.RandomState(10), N_OUTER, 2)
    _close(TSQ.expand_outer_to_inner(to_torch(vals), to_torch(ooi)),
           JSQ.expand_outer_to_inner(to_jax(vals), to_jax(ooi)))
    inner_vals = np_f32(np.random.RandomState(11), N_INNER, 2)
    got = TSQ.first_subseq_of_outer(to_torch(inner_vals), to_torch(ooi),
                                    N_OUTER)
    _close(got, JSQ.first_subseq_of_outer(to_jax(inner_vals), to_jax(ooi),
                                          N_OUTER))
    assert np.all(got[1].numpy() == 0.0)              # outer 1: none


CTX_CASES = {                     # (context_len, context_start, padded)
    "len3_default": (3, None, False),
    "len3_padded": (3, None, True),
    "len5_padded": (5, None, True),
    "len4_start-1_padded": (4, -1, True),
    "len2_start0_padded": (2, 0, True),
    "len3_start-3_padded": (3, -3, True),
    "len1": (1, 0, False),
}


def _ctx_inputs(context_len, context_start, padded, seed=12):
    rs = np.random.RandomState(seed)
    b, t, f = 3, 6, 4
    x = np_f32(rs, b, t, f)
    lens = np.asarray([6, 2, 4], np.int32)
    start = -(context_len // 2) if context_start is None else context_start
    rows = max(0, -start) + max(0, context_len + start - 1)
    pad = np_f32(rs, rows, f) if padded and rows else None
    return x, lens, pad


@pytest.mark.parametrize("case", sorted(CTX_CASES))
def test_context_projection_matches_jax(case):
    context_len, context_start, padded = CTX_CASES[case]
    x, lens, pad = _ctx_inputs(context_len, context_start, padded)
    kw = dict(context_len=context_len, context_start=context_start)
    w = np_f32(np.random.RandomState(13), 3, 6, context_len * 4)

    def jf(a, p):
        out = JSQ.context_projection(a, to_jax(lens), padding_weights=p,
                                     **kw)
        return jnp.sum(out * to_jax(w)), out

    args = (to_jax(x), None if pad is None else to_jax(pad))
    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        *args)
    tx = to_torch(x).requires_grad_(True)
    tpad = None if pad is None else to_torch(pad).requires_grad_(True)
    tout = TSQ.context_projection(tx, to_torch(lens), padding_weights=tpad,
                                  **kw)
    _close(tout, jout)
    # every row past its length is zero, not only past T
    assert np.all(tout.detach().numpy()[1, 2:] == 0.0)
    wrt = [tx] + ([tpad] if tpad is not None else [])
    tg = torch.autograd.grad(torch.sum(tout * to_torch(w)), wrt)
    for a, b in zip(tg, jg):
        _close(a, b)


def test_context_projection_without_lengths_matches_jax():
    x, _, _ = _ctx_inputs(3, None, False)
    got = TSQ.context_projection(to_torch(x), None, context_len=3)
    want = JSQ.context_projection(to_jax(x), None, context_len=3)
    _close(got, want)


@pytest.mark.parametrize("padded", [False, True], ids=["zero", "padded"])
def test_sequence_conv_matches_jax(padded):
    x, lens, pad = _ctx_inputs(3, None, padded, seed=14)
    rs = np.random.RandomState(15)
    filt, bias = np_f32(rs, 12, 5), np_f32(rs, 5)
    kw = dict(context_len=3)

    def jf(a, f_, b_, p):
        return jnp.sum(JSQ.sequence_conv(a, to_jax(lens), f_, bias=b_,
                                         padding_weights=p, **kw) ** 2)

    jargs = [to_jax(a) for a in (x, filt, bias)] + [
        None if pad is None else to_jax(pad)]
    argnums = (0, 1, 2, 3) if padded else (0, 1, 2)
    jv, jg = jax.value_and_grad(jf, argnums=argnums)(*jargs)
    targs = [to_torch(a).requires_grad_(True) for a in (x, filt, bias)] + [
        None if pad is None else to_torch(pad).requires_grad_(True)]
    tv = torch.sum(TSQ.sequence_conv(targs[0], to_torch(lens), targs[1],
                                     bias=targs[2],
                                     padding_weights=targs[3], **kw) ** 2)
    assert abs(tv.item() - float(jv)) <= TOL * abs(float(jv))
    tg = torch.autograd.grad(tv, [a for a in targs if a is not None])
    assert_tree_close(list(tg), list(jg), 1e-5)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_kmax_seq_score_matches_jax_exactly(k):
    rs = np.random.RandomState(16)
    # integer scores make ties; row 2 is shorter than k, row 3 empty
    scores = rs.randint(0, 3, (4, 6)).astype(np.float32)
    lens = np.asarray([6, 5, 2, 0], np.int32)
    want = JSQ.kmax_seq_score(to_jax(scores), to_jax(lens), k)
    got = TSQ.kmax_seq_score(to_torch(scores), to_torch(lens), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kmax_seq_score_ties_go_to_the_lower_position():
    scores = torch.tensor([[1.0, 2.0, 2.0, 0.0, 2.0]])
    got = TSQ.kmax_seq_score(scores, torch.tensor([5]), 4)
    assert got.tolist() == [[1, 2, 4, 0]]
