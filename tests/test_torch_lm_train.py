"""The transformer LM's training path in the port against the live JAX
package on the same weights: `loss` and every gradient
(`jax.value_and_grad(T.loss)`, jitted; JAX's flash runs its Pallas
forward in interpret mode), `score`, remat, the fused chunked LM-head
CE, a bf16-policy step, three adam steps, `chunked_lm_head_nll` and the
seq2seq decoder's fused CE.

Tolerances (f32): losses and log-probs 1e-4 relative; each gradient leaf
within 1e-5 of its own max |JAX| (the same f32 products in another
order measure ~5e-7); the port's remat gradients equal its plain ones
bit for bit. bf16 policy: loss 1e-2 relative, gradients 2e-2 of each
leaf's max |JAX| (measured: 0 and 8.2e-3)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optim as joptim
from paddle_tpu.core import dtypes as JD
from paddle_tpu.models import seq2seq_attn as JS
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import losses as JL
from paddle_tpu_torch.core import dtypes as TD
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
from paddle_tpu_torch.models import seq2seq_attn as TS
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.ops import flash_attention as FA
from paddle_tpu_torch.ops import losses as TL
from paddle_tpu_torch.optim import optimizers as TOPT
from torch_parity import make_models, np_f32, to_jax, to_torch

LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5

CONFIGS = {
    "mha": dict(vocab=96, dim=32, n_layers=2, n_heads=4),
    "gqa": dict(vocab=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                rope_scaling="ntk", rope_factor=4.0),
}
LENGTHS = np.array([12, 8], np.int32)


def _tokens(seed=0, t=12):
    return np.random.RandomState(seed).randint(0, 96, (2, t)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_loss_grad(jcfg, with_lengths):
    if with_lengths:
        return jax.jit(jax.value_and_grad(
            lambda p, t, n: JT.loss(p, jcfg, t, n)))
    return jax.jit(jax.value_and_grad(lambda p, t: JT.loss(p, jcfg, t)))


@functools.lru_cache(maxsize=None)
def _jax_score(jcfg):
    return jax.jit(lambda p, t, n: JT.score(p, jcfg, t, n))


def _port_loss_grad(tp, tcfg, toks, lengths=None):
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = TT.loss(tp, tcfg, to_torch(toks),
                   None if lengths is None else to_torch(lengths))
    return loss, torch.autograd.grad(loss, leaves)


def _check(loss, grads, jloss, jgrads, loss_rtol=LOSS_RTOL,
           grad_tol=GRAD_TOL):
    assert abs(loss.item() - float(jloss)) <= loss_rtol * abs(float(jloss))
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, j in zip(grads, jleaves):
        j = np.asarray(j, np.float64)
        err = np.abs(g.float().numpy() - j).max()
        assert err <= grad_tol * np.abs(j).max(), err


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("impl", ["flash", "dense"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_gradients_match_jax(name, impl, remat, monkeypatch):
    jcfg, tcfg, jp, tp = make_models(seed=1, attn_impl=impl, remat=remat,
                                     **CONFIGS[name])
    toks = _tokens()
    jloss, jgrads = _jax_loss_grad(jcfg, False)(jp, to_jax(toks))
    calls = []
    ref = FA.flash_attention_reference
    monkeypatch.setattr(FA, "flash_attention_reference",
                        lambda *a, **kw: calls.append(1) or ref(*a, **kw))
    FA.reset_launch_counts()
    loss, grads = _port_loss_grad(tp, tcfg, toks)
    assert FA.launch_counts["fwd"] == 0         # CPU: the plain forward
    # flash: one forward per layer, and one more under remat (the
    # backward runs each block again)
    want = 0 if impl == "dense" else tcfg.n_layers * (2 if remat else 1)
    assert len(calls) == want
    _check(loss, grads, jloss, jgrads)
    if remat:
        # recomputing each block in the backward changes no bit
        plain = dataclasses.replace(tcfg, remat=False)
        loss0, grads0 = _port_loss_grad(tp, plain, toks)
        assert torch.equal(loss, loss0)
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_with_lengths_and_score_match_jax(name):
    jcfg, tcfg, jp, tp = make_models(seed=2, attn_impl="flash", remat=True,
                                     **CONFIGS[name])
    toks = _tokens(1)
    jloss, jgrads = _jax_loss_grad(jcfg, True)(jp, to_jax(toks),
                                               to_jax(LENGTHS))
    loss, grads = _port_loss_grad(tp, tcfg, toks, LENGTHS)
    _check(loss, grads, jloss, jgrads)
    for lengths in (None, LENGTHS):
        jl = None if lengths is None else to_jax(lengths)
        tl = None if lengths is None else to_torch(lengths)
        jgold, jnll = _jax_score(jcfg)(jp, to_jax(toks), jl)
        with torch.no_grad():
            gold, nll = TT.score(tp, tcfg, to_torch(toks), tl)
        np.testing.assert_allclose(gold.numpy(), np.asarray(jgold),
                                   atol=LOSS_RTOL, rtol=0)
        np.testing.assert_allclose(nll.numpy(), np.asarray(jnll),
                                   rtol=LOSS_RTOL, atol=0)
    assert np.all(gold.numpy()[1, 7:] == 0.0)      # past row 1's length


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_ce_loss_and_score_match_jax(name):
    """fused_ce_chunk=7 over N = 2 x 11 = 22 positions: the last chunk is
    padded."""
    jcfg, tcfg, jp, tp = make_models(seed=3, attn_impl="flash",
                                     fused_ce_chunk=7, **CONFIGS[name])
    toks = _tokens(2)
    jloss, jgrads = _jax_loss_grad(jcfg, True)(jp, to_jax(toks),
                                               to_jax(LENGTHS))
    loss, grads = _port_loss_grad(tp, tcfg, toks, LENGTHS)
    _check(loss, grads, jloss, jgrads)
    unfused = dataclasses.replace(tcfg, fused_ce_chunk=None)
    loss0, _ = _port_loss_grad(tp, unfused, toks, LENGTHS)
    assert abs(loss.item() - loss0.item()) <= 1e-6 * abs(loss0.item())
    jgold, jnll = _jax_score(jcfg)(jp, to_jax(toks), to_jax(LENGTHS))
    gold, nll = TT.score(tp, tcfg, to_torch(toks), to_torch(LENGTHS))
    np.testing.assert_allclose(gold.detach().numpy(), np.asarray(jgold),
                               atol=LOSS_RTOL, rtol=0)
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jnll),
                               rtol=LOSS_RTOL, atol=0)


def test_bf16_policy_loss_matches_jax():
    jcfg, tcfg, jp, tp = make_models(seed=4, attn_impl="flash", remat=True,
                                     **CONFIGS["mha"])
    toks = _tokens(3)
    jprev, tprev = JD.default_policy(), TD.default_policy()
    try:
        JD.set_default_policy(JD.bf16_compute_policy())
        TD.set_default_policy(TD.bf16_compute_policy())
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, t: JT.loss(p, jcfg, t)))(jp, to_jax(toks))
        loss, grads = _port_loss_grad(tp, tcfg, toks)
    finally:
        JD.set_default_policy(jprev)
        TD.set_default_policy(tprev)
    assert JD.default_policy() == jprev and TD.default_policy() == tprev
    assert all(g.dtype == torch.float32 for g in grads)   # f32 params
    _check(loss, grads, jloss, jgrads, loss_rtol=1e-2, grad_tol=2e-2)


def test_three_adam_steps_match_jax():
    """The bench's hand-rolled step (value_and_grad, then adam's update)
    on both sides, the same batch each step: the same losses."""
    jcfg, tcfg, jp, tp = make_models(seed=5, attn_impl="flash", remat=True,
                                     **CONFIGS["gqa"])
    toks = _tokens(4)
    jopt, topt = joptim.adam(1e-2), TOPT.adam(1e-2)
    jst, tst = jopt.init(jp), topt.init(tp)
    jstep = _jax_loss_grad(jcfg, False)
    jupdate = jax.jit(jopt.update)
    jl, tl = [], []
    for i in range(3):
        v, g = jstep(jp, to_jax(toks))
        jp, jst = jupdate(g, jst, jp, jnp.asarray(i, jnp.int32))
        jl.append(float(v))
        loss, grads = _port_loss_grad(tp, tcfg, toks)
        it = iter(grads)
        topt.update(tree_map(lambda _: next(it), tp), tst, tp,
                    torch.tensor(i, dtype=torch.int32))
        tl.append(loss.item())
    assert jl[2] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_chunked_lm_head_nll_matches_jax(bias):
    rs = np.random.RandomState(6)
    h, w, b = np_f32(rs, 3, 5, 8), np_f32(rs, 8, 30), np_f32(rs, 30)
    y = rs.randint(0, 30, (3, 5)).astype(np.int32)
    g = np_f32(rs, 3, 5)

    def jf(h, w, b):
        nll = JL.chunked_lm_head_nll(h, w, to_jax(y), chunk=4,
                                     bias=b if bias else None)
        return jnp.sum(nll * to_jax(g)), nll

    (_, jnll), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(
        to_jax(h), to_jax(w), to_jax(b))
    ht, wt, bt = (to_torch(x).requires_grad_() for x in (h, w, b))
    nll = TL.chunked_lm_head_nll(ht, wt, to_torch(y), chunk=4,
                                 bias=bt if bias else None)
    assert nll.dtype == torch.float32 and nll.shape == (3, 5)
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jnll),
                               rtol=LOSS_RTOL, atol=LOSS_RTOL)
    grads = torch.autograd.grad((nll * to_torch(g)).sum(), (ht, wt, bt),
                                allow_unused=True)
    for got, want in zip(grads[:2 + bias], jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
    if not bias:
        assert grads[2] is None
    # the same nll as the plain head
    logits = to_torch(h) @ to_torch(w) + (to_torch(b) if bias else 0)
    plain = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, to_torch(y).long()[..., None])[..., 0]
    torch.testing.assert_close(nll.detach(), plain, atol=1e-5, rtol=0)


def test_seq2seq_fused_ce_loss_matches_jax():
    """seq2seq_attn.loss(fused_ce_chunk=5) -- the decoder's output layer
    in chunks with its bias -- against JAX's, both encoders on their
    scan path. The source embedding and attention vector are scaled up
    as in test_torch_seq2seq.py, so that w_dec's gradient is not f32
    noise (~1e-9 of the others' at the initializer's scales)."""
    b, s, t, v = 3, 6, 5, 40
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        JS.init_params(jax.random.key(0), v, v, embed_dim=8, hidden=16))
    jp["src_embed"] = jp["src_embed"] * 20.0
    jp["attn"]["v"] = jp["attn"]["v"] * 10.0
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    rs = np.random.RandomState(7)
    batch = (rs.randint(2, v, (b, s)).astype(np.int32),
             np.array([6, 3, 5], np.int32),
             rs.randint(2, v, (b, t)).astype(np.int32),
             np.array([5, 2, 4], np.int32))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, *a: JS.loss(p, *a, fused_ce_chunk=5)))(
        jp, *(to_jax(a) for a in batch))
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    loss = TS.loss(tp, *(to_torch(a) for a in batch), fused_ce_chunk=5,
                   impl="scan")
    grads = torch.autograd.grad(loss, leaves)
    _check(loss, grads, jloss, jgrads, grad_tol=1e-4)
