"""The recurrent-group leftovers of the port against the JAX package:
`scan_subsequences` over a 2-level nested batch (with and without boots),
`RecurrentGroupLayer` alone, reversed and inside a `Sequential`, and the
globally normalized `cross_entropy_over_beam` with the gold path kept
and pruned (values and gradients). Tolerance f32 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import recurrent_group as JRG
from paddle_tpu.ops import beam_search as JBS
from paddle_tpu_torch.core.pytree import tree_leaves
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.nn import layers as TNL
from paddle_tpu_torch.nn import module as TNM
from paddle_tpu_torch.nn import recurrent_group as TRG
from paddle_tpu_torch.ops import beam_search as TBS
from torch_parity import (assert_tree_close, named_leaves, np_f32, to_jax,
                          to_torch)

B, F, H = 3, 6, 8
TOL = 1e-5


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def _close(got, want, tol=TOL):
    g, w = named_leaves(got), named_leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        assert np.abs(g[k] - w[k]).max(initial=0.0) <= tol, k


def _groups(make, **kw):
    jstep, jmems = getattr(JRG, make)(F, H)
    tstep, tmems = getattr(TRG, make)(F, H)
    return (JRG.RecurrentGroup(jstep, jmems, **kw),
            TRG.RecurrentGroup(tstep, tmems, **kw))


@pytest.mark.parametrize("boot", [False, True], ids=["zeros", "booted"])
@pytest.mark.parametrize("make", ["gru_group", "lstm_group"])
def test_scan_subsequences_matches_jax(make, boot):
    jg, tg = _groups(make)
    jp = _f32(jg.init(jax.random.key(0), jnp.zeros((B, F), jnp.float32),
                      batch=B))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    rs = np.random.RandomState(1)
    so, si = 3, 4
    x = np_f32(rs, B, so, si, F)
    inner = rs.randint(0, si + 1, (B, so)).astype(np.int32)
    inner[0, 0] = 0                                   # an empty one
    boots = {"h": np_f32(rs, B, so, H)} if boot else None
    jo, jf = JRG.scan_subsequences(
        jg, jp, to_jax(x), to_jax(inner),
        boots=None if boots is None else {"h": to_jax(boots["h"])})
    to, tf = TRG.scan_subsequences(
        tg, tp, to_torch(x), to_torch(inner),
        boots=None if boots is None else {"h": to_torch(boots["h"])})
    assert tuple(to.shape) == (B, so, si, H)
    _close(to, jo)
    _close(tf, jf)
    # each sub-sequence alone through run() gives the same
    o1, f1 = tg.run(tp, to_torch(x[1, 2:3]), to_torch(inner[1, 2:3]),
                    boots=None if boots is None
                    else {"h": to_torch(boots["h"][1, 2:3])})
    torch.testing.assert_close(to[1, 2], o1[0])
    torch.testing.assert_close(tf["h"][1, 2], f1["h"][0])


@pytest.mark.parametrize("reverse", [False, True])
def test_recurrent_group_layer_matches_jax(reverse):
    jstep, jmems = JRG.lstm_group(F, H)
    tstep, tmems = TRG.lstm_group(F, H)
    jl = JRG.RecurrentGroupLayer(jstep, jmems, reverse=reverse)
    tl = TRG.RecurrentGroupLayer(tstep, tmems, reverse=reverse)
    t = 5
    jp, _ = jl.init(jax.random.key(2), jnp.zeros((B, t, F), jnp.float32))
    jp = _f32(jp)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    tp0, _ = tl.init(0, TNM.ShapeSpec((B, t, F)), device="cpu")
    assert sorted(named_leaves(tp0)) == sorted(named_leaves(tp))
    assert tl.out_spec(TNM.ShapeSpec((B, t, F))).shape == (B, t, H)
    rs = np.random.RandomState(3)
    x = np_f32(rs, B, t, F)
    lens = np.asarray([5, 2, 3], np.int32)
    w = np_f32(rs, B, t, H)

    def jloss(p):
        out, _ = jl.apply(p, {}, to_jax(x), to_jax(lens))
        return jnp.sum(out * to_jax(w)), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for a in leaves:
        a.requires_grad_(True)
    tout, _ = tl.apply(tp, {}, to_torch(x), to_torch(lens))
    _close(tout, jout)
    grads = torch.autograd.grad(torch.sum(tout * to_torch(w)), leaves)
    it = iter(grads)
    assert_tree_close({k: next(it) for k in tp}, jg, 1e-4)


def test_recurrent_group_layer_in_sequential_matches_jax():
    t, vocab = 5, 20
    jstep, jmems = JRG.lstm_group(F, H)
    tstep, tmems = TRG.lstm_group(F, H)
    jmodel = jnn.Sequential([
        jnn.Embedding(vocab, F, name="emb"),
        JRG.RecurrentGroupLayer(jstep, jmems, name="rg"),
        jnn.Dense(3, name="fc")])
    tmodel = TNM.Sequential([
        TNL.Embedding(vocab, F, name="emb"),
        TRG.RecurrentGroupLayer(tstep, tmems, name="rg"),
        TNL.Dense(3, name="fc")])
    jp, _ = jmodel.init(jax.random.key(4), jnp.zeros((B, t), jnp.int32))
    jp = _f32(jp)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    toks = np.random.RandomState(5).randint(0, vocab, (B, t)).astype(
        np.int32)
    jout, _ = jmodel.apply(jp, {}, to_jax(toks))
    tout, _ = tmodel.apply(tp, {}, to_torch(toks))
    assert tuple(tout.shape) == (B, t, 3)
    _close(tout, jout)


def _beam_data(seed, e=3, b=4, k=3):
    """Random beams: NEG_INF pads some slots; gold survives in rows 0 and
    2, is pruned at the last step in row 1 and at step 1 in row 3."""
    rs = np.random.RandomState(seed)
    scores = np_f32(rs, e, b, k)
    scores[1, 2, 2] = TBS.NEG_INF
    parents = rs.randint(0, k, (e, b, k)).astype(np.int32)
    gold = rs.randint(0, k, (e, b)).astype(np.int32)
    gold[1, 2] = 1                  # row 2's gold avoids the padded slot
    gold[2:, 1] = -1
    gold[1:, 3] = -1
    return scores, parents, gold


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_entropy_over_beam_matches_jax(seed):
    scores, parents, gold = _beam_data(seed)

    def jf(s):
        loss = JBS.cross_entropy_over_beam(s, to_jax(parents), to_jax(gold))
        return jnp.sum(loss), loss

    (_, jl), jg = jax.value_and_grad(jf, has_aux=True)(to_jax(scores))
    ts = to_torch(scores).requires_grad_(True)
    tl = TBS.cross_entropy_over_beam(ts, to_torch(parents), to_torch(gold))
    _close(tl, jl)
    (tg,) = torch.autograd.grad(tl.sum(), ts)
    _close(tg, jg)
    assert np.isfinite(tl.detach().numpy()).all()


def test_cross_entropy_over_beam_worked_example():
    """E=2, B=2, K=2: row 0's gold survives at slot 0, row 1's is pruned
    at step 1 and enters as the extra column."""
    scores = torch.tensor([[[1.0, 0.5], [0.4, 0.6]],
                           [[0.2, 0.3], [0.1, 0.7]]])
    parents = torch.tensor([[[0, 0], [0, 0]], [[0, 1], [1, 0]]])
    gold = torch.tensor([[0, 1], [0, -1]])
    got = TBS.cross_entropy_over_beam(scores, parents, gold)
    want = [np.log(np.exp(1.2) + np.exp(0.8)) - 1.2,
            np.log(np.exp(0.7) + np.exp(1.1) + np.exp(0.6)) - 0.6]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
