"""The port's seq2seq-attention NMT path against the JAX package's: the
recurrent-group engine (`RecurrentGroup.run` with `lstm_group` and
`gru_group`), beam search and greedy search on a scripted step, and
`models.seq2seq_attn` -- the loss and every leaf's gradient, three adam
steps, beam and greedy generation -- with JAX's encoder on its Pallas GRU
(interpret mode, forced with `PADDLE_TPU_RNN_IMPL=pallas`) and the
port's on its fused GRU's plain versions; and the weight bridge over the
seq2seq tree and adam's moments.

Tolerances (f32): 1e-5 on values, 1e-4 relative to the largest magnitude
on gradients and on losses, exact on tokens and lengths."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optim as joptim
from paddle_tpu.models import seq2seq_attn as JS
from paddle_tpu.nn import recurrent_group as JRG
from paddle_tpu.ops import beam_search as JBS
from paddle_tpu.train.state import TrainState as JTrainState
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
from paddle_tpu_torch.models import seq2seq_attn as TS
from paddle_tpu_torch.models.weights import (params_from_numpy,
                                             params_to_numpy,
                                             train_state_from_numpy)
from paddle_tpu_torch.nn import recurrent_group as TRG
from paddle_tpu_torch.ops import beam_search as TBS
from paddle_tpu_torch.ops import fused_gru as FG
from paddle_tpu_torch.optim import optimizers as TOPT
from torch_parity import np_f32, to_jax, to_torch

B, S, T = 4, 7, 6
SRC_V, TGT_V, E, H = 40, 36, 8, 16
SRC_LENS = [7, 3, 5, 1]
TGT_LENS = [6, 2, 4, 5]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _close_rel(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    _close(got, want, rel * max(np.abs(want).max(), 1e-30))


def _f32_tree(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def _grad_tree(params, grads):
    """Gradients listed in tree_leaves(params) order -> params' tree."""
    it = iter(grads)
    return tree_map(lambda _: next(it), params)


# -- the recurrent-group engine ------------------------------------------------


@pytest.mark.parametrize("make", ["lstm_group", "gru_group"])
@pytest.mark.parametrize("reverse", [False, True])
def test_recurrent_group_run_matches_jax(make, reverse):
    rs = np.random.RandomState(0)
    f, h = 10, 12
    jstep, jmems = getattr(JRG, make)(f, h)
    tstep, tmems = getattr(TRG, make)(f, h)
    jg = JRG.RecurrentGroup(jstep, jmems, reverse=reverse)
    tg = TRG.RecurrentGroup(tstep, tmems, reverse=reverse)
    jp = _f32_tree(jg.init(jax.random.key(1), jnp.zeros((B, f)), batch=B))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    x = np_f32(rs, B, T, f)
    lens = np.asarray([6, 2, 4, 1], np.int32)
    w_o = np_f32(rs, B, T, h)
    boots = {"h": np_f32(rs, B, h)}

    def jloss(p, x):
        out, fin = jg.run(p, x, to_jax(lens),
                          boots={"h": to_jax(boots["h"])})
        return jnp.sum(out * w_o) + jnp.sum(fin["h"]), (out, fin)

    (jval, (jout, jfin)), jgr = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, to_jax(x))
    tx = to_torch(x).requires_grad_(True)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    out, fin = tg.run(tp, tx, to_torch(lens),
                      boots={"h": to_torch(boots["h"])})
    loss = torch.sum(out * to_torch(w_o)) + torch.sum(fin["h"])
    _close(out.detach(), jout, 1e-5)
    assert sorted(fin) == sorted(jfin)
    for k in fin:
        _close(fin[k].detach(), jfin[k], 1e-5)
    # padded positions are zeroed
    assert float(out.detach()[3, 1:].abs().sum()) == 0.0
    grads = torch.autograd.grad(loss, [tx] + leaves)
    _close_rel(grads[0], jgr[1])
    for t, j in zip(grads[1:], jax.tree_util.tree_leaves(jgr[0])):
        _close_rel(t, j)


def test_recurrent_group_boot_errors():
    step, mems = TRG.gru_group(4, 8)
    group = TRG.RecurrentGroup(step, {"h": TRG.Memory(8, boot="extern")})
    params = step.init(0, {}, ())
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="boots extern"):
        group.run(params, x)
    with pytest.raises(ValueError, match="unknown boot"):
        TRG.RecurrentGroup(step, mems).run(
            params, x, boots={"h": torch.zeros(2, 8), "c": torch.zeros(2, 8)})
    with pytest.raises(ValueError, match="boot"):
        TRG.Memory(8, boot="ones")


# -- beam and greedy search on a scripted step ---------------------------------

V, MAXLEN, EOS, BOS = 12, 8, 0, 1


def _scripted(seed, eos_bias):
    """A deterministic step: logits = table[prev] + state, state <- 0.5
    state + table[prev]; the same float32 arithmetic on both sides."""
    rs = np.random.RandomState(seed)
    table = (2.0 * rs.standard_normal((V, V))).astype(np.float32)
    table[:, EOS] += eos_bias
    state0 = rs.standard_normal((3, V)).astype(np.float32)

    def jstep(prev, st):
        e = jnp.asarray(table)[prev]
        return e + st, 0.5 * st + e

    def tstep(prev, st):
        e = torch.from_numpy(table)[prev.long()]
        return e + st, 0.5 * st + e

    return state0, jstep, tstep


@pytest.mark.parametrize("eos_bias", [-3.0, 3.0], ids=["run_to_max_len",
                                                       "early_eos"])
@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
def test_beam_search_matches_jax(eos_bias, length_penalty):
    state0, jstep, tstep = _scripted(3, eos_bias)
    kw = dict(batch_size=3, beam_size=3, max_len=MAXLEN, bos_id=BOS,
              eos_id=EOS, vocab_size=V, length_penalty=length_penalty)
    jt, js, jl = JBS.beam_search(to_jax(state0), jstep, **kw)
    calls = []

    def counted(prev, st):
        calls.append(1)
        return tstep(prev, st)

    tt, ts, tl = TBS.beam_search(to_torch(state0), counted, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(ts, js, 1e-5)
    assert tt.dtype == torch.int32 and tl.dtype == torch.int32
    if eos_bias > 0:
        # every beam finished early: the loop stopped there
        assert len(calls) < MAXLEN and bool((tl < MAXLEN).all())
    else:
        assert len(calls) == MAXLEN


@pytest.mark.parametrize("eos_bias", [-3.0, 3.0])
def test_greedy_search_matches_jax(eos_bias):
    state0, jstep, tstep = _scripted(4, eos_bias)
    kw = dict(batch_size=3, max_len=MAXLEN, bos_id=BOS, eos_id=EOS)
    jt, jl = JBS.greedy_search(to_jax(state0), jstep, **kw)
    tt, tl = TBS.greedy_search(to_torch(state0), tstep, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_beam_search_bos_tokens_and_modify_logits():
    """Per-row first tokens and a logits hook that bans token 5."""
    state0, jstep, tstep = _scripted(5, 0.5)
    ban = lambda lib: (lambda step, logits, st: logits.at[:, 5].set(-1e9)
                       if lib == "jax" else logits.index_fill(1, torch.tensor(
                           [5]), -1e9))
    kw = dict(batch_size=3, beam_size=2, max_len=MAXLEN, bos_id=BOS,
              eos_id=EOS, vocab_size=V)
    bos = np.asarray([1, 2, 3], np.int32)
    jt, js, jl = JBS.beam_search(to_jax(state0), jstep, bos_tokens=bos,
                                 modify_logits_fn=ban("jax"), **kw)
    tt, ts, tl = TBS.beam_search(to_torch(state0), tstep,
                                 bos_tokens=to_torch(bos),
                                 modify_logits_fn=ban("torch"), **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(ts, js, 1e-5)
    assert not bool((tt == 5).any())


# -- the seq2seq model ---------------------------------------------------------


def _models(seed=0, out_scale=1.0, eos_bias=0.0):
    """JAX and port parameters on the same weights. The source embedding
    and the attention vector are scaled up so the attention scores leave
    tanh's linear range (at the initializer's scales w_dec's gradient is
    ~1e-7 of the others', f32 rounding noise); the output layer is scaled
    (and EOS's bias raised) where a test needs peaked, finishing
    decodes."""
    jp = _f32_tree(JS.init_params(jax.random.key(seed), SRC_V, TGT_V,
                                  embed_dim=E, hidden=H))
    jp["src_embed"] = jp["src_embed"] * 20.0
    jp["attn"]["v"] = jp["attn"]["v"] * 10.0
    jp["out"]["kernel"] = jp["out"]["kernel"] * out_scale
    jp["out"]["bias"] = jp["out"]["bias"].at[0].set(eos_bias)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    return jp, tp


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    src = rs.randint(2, SRC_V, (B, S)).astype(np.int32)
    tgt = rs.randint(2, TGT_V, (B, T)).astype(np.int32)
    return (src, np.asarray(SRC_LENS, np.int32), tgt,
            np.asarray(TGT_LENS, np.int32))


def test_init_params_tree_matches_jax():
    jp = JS.init_params(jax.random.key(0), SRC_V, TGT_V, embed_dim=E,
                        hidden=H)
    tp = TS.init_params(0, SRC_V, TGT_V, embed_dim=E, hidden=H, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert tree_map(lambda t: tuple(t.shape), tp) == jshapes
    assert tp["src_embed"].std().item() == pytest.approx(0.05, rel=0.2)
    lim = 1.0 / np.sqrt(2 * H)
    assert float(tp["attn"]["w_enc"].abs().max()) <= lim


def test_loss_and_gradients_match_jax(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RNN_IMPL", "pallas")
    jp, tp = _models()
    src, sl, tgt, tl = _batch()
    jval, jg = jax.jit(jax.value_and_grad(JS.loss))(
        jp, to_jax(src), to_jax(sl), to_jax(tgt), to_jax(tl))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    FG.reset_launch_counts()
    loss = TS.loss(tp, to_torch(src), to_torch(sl), to_torch(tgt),
                   to_torch(tl))
    grads = torch.autograd.grad(loss, leaves)
    assert FG.launch_counts == {"fwd": 0, "bwd": 0}
    assert abs(loss.item() - float(jval)) <= 1e-5 * abs(float(jval))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads) == 18
    for t, j in zip(grads, jleaves):
        _close_rel(t, j)
    # the scan path of the encoder gives the same loss
    scan = TS.loss(tp, to_torch(src), to_torch(sl), to_torch(tgt),
                   to_torch(tl), impl="scan")
    assert abs(scan.item() - loss.item()) <= 1e-5 * abs(loss.item())
    # the chunked output projection gives the same loss (JAX's fused
    # loss is held against this one in test_torch_lm_train.py)
    fused = TS.loss(tp, to_torch(src), to_torch(sl), to_torch(tgt),
                    to_torch(tl), fused_ce_chunk=4)
    assert abs(fused.item() - loss.item()) <= 1e-5 * abs(loss.item())


def test_three_adam_steps_match_jax(monkeypatch):
    """The bench's hand-rolled step (value_and_grad, then adam's update)
    on both sides: the same losses at every step."""
    monkeypatch.setenv("PADDLE_TPU_RNN_IMPL", "pallas")
    jp, tp = _models(seed=2)
    batch = _batch(seed=3)
    jopt, topt = joptim.adam(1e-2), TOPT.adam(1e-2)
    jst, tst = jopt.init(jp), topt.init(tp)
    jloss_grad = jax.jit(jax.value_and_grad(JS.loss))
    jupdate = jax.jit(jopt.update)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    jl, tl = [], []
    for i in range(3):
        v, g = jloss_grad(jp, *(to_jax(a) for a in batch))
        jp, jst = jupdate(g, jst, jp, jnp.asarray(i, jnp.int32))
        jl.append(float(v))
        loss = TS.loss(tp, *(to_torch(a) for a in batch))
        grads = torch.autograd.grad(loss, leaves)
        topt.update(_grad_tree(tp, grads), tst, tp,
                    torch.tensor(i, dtype=torch.int32))
        tl.append(loss.item())
    assert jl[2] < jl[0]
    _close_rel(tl, jl)


def test_generate_and_greedy_match_jax(monkeypatch):
    """Beam 3 and greedy decodes of the same weights (a peaked output
    layer, EOS likely enough that some beams finish)."""
    monkeypatch.setenv("PADDLE_TPU_RNN_IMPL", "pallas")
    jp, tp = _models(seed=4, out_scale=6.0, eos_bias=1.0)
    src, sl, _, _ = _batch(seed=5)
    jt, js, jl = jax.jit(functools.partial(JS.generate, beam_size=3,
                                           max_len=8))(jp, to_jax(src),
                                                       to_jax(sl))
    FG.reset_launch_counts()
    tt, ts, tl = TS.generate(tp, to_torch(src), to_torch(sl), beam_size=3,
                             max_len=8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close_rel(ts, js)
    assert bool((tl < 8).any()), "no beam finished: a weak test"
    jgt, jgl = jax.jit(functools.partial(JS.greedy_generate, max_len=8))(
        jp, to_jax(src), to_jax(sl))
    tgt_, tgl = TS.greedy_generate(tp, to_torch(src), to_torch(sl),
                                   max_len=8)
    np.testing.assert_array_equal(tgt_.numpy(), np.asarray(jgt))
    np.testing.assert_array_equal(tgl.numpy(), np.asarray(jgl))
    assert FG.launch_counts == {"fwd": 0, "bwd": 0}


def test_weight_bridge_round_trips_tree_and_adam_state(monkeypatch):
    """The nested seq2seq tree crosses unchanged, and so does adam's m/v:
    one more adam step from a bridged JAX state gives JAX's parameters."""
    monkeypatch.setenv("PADDLE_TPU_RNN_IMPL", "pallas")
    jp, _ = _models(seed=6)
    batch = _batch(seed=7)
    jopt = joptim.adam(1e-2)
    jst = jopt.init(jp)
    grad = jax.jit(jax.grad(JS.loss))
    update = jax.jit(jopt.update)
    jp, jst = update(grad(jp, *(to_jax(a) for a in batch)), jst, jp,
                     jnp.asarray(0, jnp.int32))
    state = train_state_from_numpy(jax.device_get(JTrainState(
        params=jp, model_state={}, opt_state=jst,
        step=jnp.asarray(1, jnp.int32))), device="cpu")
    back = params_to_numpy(state.params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.device_get(jp))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert sorted(state.opt_state) == ["m", "v"]
    # one more step on each side from the same state
    jp2, _ = update(grad(jp, *(to_jax(a) for a in batch)), jst, jp,
                    jnp.asarray(1, jnp.int32))
    tp = state.params
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(TS.loss(tp, *(to_torch(a) for a in batch)),
                                leaves)
    TOPT.adam(1e-2).update(_grad_tree(tp, grads), state.opt_state, tp,
                           state.step)
    for t, j in zip(leaves, jax.tree_util.tree_leaves(jp2)):
        _close(t.detach(), j, 1e-5)
