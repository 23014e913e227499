"""The port's mixture-of-experts transformer LM held against the live JAX
package on the same weights: `loss` and `score` with a lengths mask
(values and every gradient, 1e-4 of each leaf's scale) under top-k and
expert-choice routing, with remat and the fused CE; the summed aux
loss; `generate` tokens exactly (right-padded prompts whose pads claim
no capacity); the weight bridge and `serve.quant` over stacked `[E,
...]` leaves; `Trainer(aux_loss_weight=)` training a model with an MoE
layer; and `DecodeEngine` serving an MoE LM: tokens equal to
`generate`'s, also with bucket pads and an inactive slot under a tight
capacity (where unmasked padding would evict real tokens), with int8
weights over stacked experts, int8 KV and speculative verify rounds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import losses as JL
from paddle_tpu.optim import optimizers as JO
from paddle_tpu.serve import quant as JQ
from paddle_tpu.train import trainer as JTR
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.weights import params_from_numpy, \
    params_to_numpy
from paddle_tpu_torch.nn import layers as TNL
from paddle_tpu_torch.nn import module as TNM
from paddle_tpu_torch.ops import losses as TL
from paddle_tpu_torch.optim import optimizers as TO
from paddle_tpu_torch.parallel import moe as TM
from paddle_tpu_torch.serve import quant as TQ
from paddle_tpu_torch.serve.engine import DecodeEngine
from paddle_tpu_torch.train import state as TS
from paddle_tpu_torch.train import trainer as TTR
from torch_parity import assert_tree_close, make_models, to_jax, to_torch

MOE = dict(vocab=32, dim=16, n_layers=2, n_heads=2, mlp_ratio=2,
           attn_impl="dense", moe_experts=4, moe_every=2)
TOKS = np.random.RandomState(0).randint(0, 32, (4, 10)).astype(np.int32)
LENS = np.array([10, 7, 5, 3], np.int32)


def models(seed=0, embed_std=1.0, **kw):
    return make_models(seed=seed, embed_std=embed_std, **dict(MOE, **kw))


def jax_loss_and_grads(jp, jcfg, toks, lens):
    f = jax.jit(jax.value_and_grad(
        lambda p, t, ln: JT.loss(p, jcfg, t, ln)))
    val, g = f(jp, to_jax(toks), None if lens is None else to_jax(lens))
    return float(val), jax.device_get(g)


def torch_loss_and_grads(tp, tcfg, toks, lens):
    leaves = tree_leaves(tp)
    live = [p.clone().requires_grad_(True) for p in leaves]
    it = iter(live)
    params = tree_map(lambda _: next(it), tp)
    val = TT.loss(params, tcfg, to_torch(toks),
                  None if lens is None else to_torch(lens))
    grads = torch.autograd.grad(val, live)
    it = iter(grads)
    return val.item(), tree_map(lambda _: next(it), tp)


@pytest.mark.parametrize("kw", [
    dict(moe_capacity_factor=1.0),
    dict(moe_capacity_factor=1.0, remat=True, fused_ce_chunk=4),
    dict(moe_router="expert_choice", moe_capacity_factor=2.0),
    dict(moe_every=1, moe_k=1, n_heads=4, n_kv_heads=2,
         moe_capacity_factor=1.25),
], ids=["topk", "topk_remat_fused_ce", "expert_choice", "k1_every_block_gqa"])
def test_moe_loss_and_gradients_match_jax(kw):
    jcfg, tcfg, jp, tp = models(seed=1, **kw)
    want, jg = jax_loss_and_grads(jp, jcfg, TOKS, LENS)
    got, tg = torch_loss_and_grads(tp, tcfg, TOKS, LENS)
    assert abs(got - want) <= 1e-5 * abs(want)
    assert_tree_close(tg, jg, 1e-4)
    moe = [b for b in tg["blocks"] if "moe" in b]
    assert moe and all(float(b["moe"]["w1"].abs().max()) > 0 for b in moe)


def test_moe_aux_and_score_match_jax():
    jcfg, tcfg, jp, tp = models(seed=2, moe_capacity_factor=1.0)
    toks, lens = TOKS, LENS
    mask = np.arange(9)[None, :] < lens[:, None]
    _, jaux = jax.jit(lambda p, t, m: JT._forward(p, jcfg, t, token_mask=m))(
        jp, to_jax(toks[:, :-1]), to_jax(mask))
    with torch.no_grad():
        _, taux = TT._forward(tp, tcfg, to_torch(toks[:, :-1]),
                              token_mask=to_torch(mask))
    assert abs(taux.item() - float(jaux)) <= 1e-6 * abs(float(jaux))
    # pads change the aux: without the mask the router counts them
    with torch.no_grad():
        _, unmasked = TT._forward(tp, tcfg, to_torch(toks[:, :-1]))
    assert unmasked.item() != taux.item()
    jlp, jnll = jax.jit(lambda p, t, ln: JT.score(p, jcfg, t, ln))(
        jp, to_jax(toks), to_jax(lens))
    tlp, tnll = TT.score(tp, tcfg, to_torch(toks), to_torch(lens))
    np.testing.assert_allclose(tlp.detach().numpy(), np.asarray(jlp),
                               atol=1e-4)
    np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll),
                               rtol=1e-5)
    # the aux term is weighted into the loss, in both packages
    no_aux = dataclasses.replace(tcfg, moe_aux_weight=0.0)
    with torch.no_grad():
        a = TT.loss(tp, tcfg, to_torch(toks)).item()
        b = TT.loss(tp, no_aux, to_torch(toks)).item()
    assert a != b
    want = jax.jit(lambda p, t: JT.loss(p, jcfg, t))(jp, to_jax(toks))
    assert abs(a - float(want)) <= 1e-5 * abs(a)


def test_bf16_policy_keeps_the_moe_lm_in_f32_as_jax():
    """Under the bf16 compute policy a dense layer's f32 bias promotes its
    bf16 product, so the residual stream, the router and the experts run
    in f32 in both packages (ROADMAP, "The bf16 policy keeps the LM in
    f32")."""
    from paddle_tpu.core import dtypes as JD
    from paddle_tpu_torch.core import dtypes as TD

    jcfg, tcfg, jp, tp = models(seed=8, moe_capacity_factor=1.0)
    jprev, tprev = JD.default_policy(), TD.default_policy()
    try:
        JD.set_default_policy(JD.bf16_compute_policy())
        TD.set_default_policy(TD.bf16_compute_policy())
        want, jg = jax_loss_and_grads(jp, jcfg, TOKS, LENS)
        got, tg = torch_loss_and_grads(tp, tcfg, TOKS, LENS)
        jx, _ = jax.jit(lambda p, t: JT._forward(
            p, jcfg, t, return_hidden=True))(jp, to_jax(TOKS))
        with torch.no_grad():
            tx, _ = TT._forward(tp, tcfg, to_torch(TOKS), return_hidden=True)
    finally:
        JD.set_default_policy(jprev)
        TD.set_default_policy(tprev)
    assert jx.dtype == jnp.float32 and tx.dtype == torch.float32
    assert abs(got - want) <= 1e-2 * abs(want)
    assert_tree_close(tg, jg, 2e-2)


def test_bad_moe_router_raises():
    _, tcfg, _, tp = models(seed=3)
    bad = dataclasses.replace(tcfg, moe_router="expert-choice")
    with pytest.raises(ValueError, match="moe_router"):
        TT.loss(tp, bad, torch.zeros((2, 6), dtype=torch.int32))


@pytest.mark.parametrize("kw", [dict(moe_capacity_factor=1.0),
                                dict(moe_router="expert_choice")])
def test_moe_generate_matches_jax(kw):
    jcfg, tcfg, jp, tp = models(seed=4, embed_std=0.3, **kw)
    prompt = np.random.RandomState(4).randint(1, 32, (3, 8)).astype(np.int32)
    lens = np.array([8, 5, 3], np.int32)
    jgen = jax.jit(lambda p, pr, ln: JT.generate(p, jcfg, pr, 7,
                                                 prompt_lens=ln))
    for pl in (None, lens):
        want = np.asarray(jgen(jp, to_jax(prompt),
                               None if pl is None else to_jax(pl)))
        got = TT.generate(tp, tcfg, to_torch(prompt), 7,
                          prompt_lens=None if pl is None else to_torch(pl))
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[:, 8:].ravel().tolist())) > 2


def test_moe_speculative_routes_each_row_alone():
    """JAX's speculative rounds run one row at a time (vmap): an MoE
    target routes each row's window on its own capacity, and so does the
    port."""
    jcfg, tcfg, jp, tp = models(seed=5, embed_std=0.3,
                                moe_capacity_factor=1.0)
    djcfg, dtcfg, jdp, tdp = make_models(
        seed=9, embed_std=0.3, vocab=32, dim=8, n_layers=1, n_heads=2,
        mlp_ratio=2, attn_impl="dense")
    prompt = np.random.RandomState(5).randint(1, 32, (3, 6)).astype(np.int32)
    want, want_r = jax.jit(lambda p, dp, pr: JT.speculative_generate(
        p, jcfg, dp, djcfg, pr, 6, draft_k=3, return_stats=True))(
            jp, jdp, to_jax(prompt))
    got, got_r = TT.speculative_generate(tp, tcfg, tdp, dtcfg,
                                         to_torch(prompt), 6, draft_k=3,
                                         return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


def test_stacked_expert_leaves_cross_the_bridge_and_quantize_per_expert():
    jcfg, tcfg, jp, tp = models(seed=6)
    back = params_to_numpy(tp)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(jax.device_get(jp)),
            jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    qj = jax.device_get(JQ.quantize_params(jp))
    qt = TQ.quantize_params(tp)
    for name in ("w1", "w2"):
        jl, tl = qj["blocks"][1]["moe"][name], qt["blocks"][1]["moe"][name]
        assert isinstance(tl, TQ.QuantizedTensor)
        assert tuple(tl.scale.shape) == (4, tl.q.shape[-1])   # per expert
        np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
        np.testing.assert_allclose(tl.scale.numpy(), np.asarray(jl.scale),
                                   rtol=1e-7)
    assert isinstance(qt["blocks"][1]["moe"]["router"]["kernel"],
                      TQ.QuantizedTensor)
    assert not isinstance(qt["blocks"][1]["moe"]["b1"], TQ.QuantizedTensor)
    # int8 weights over stacked experts decode as JAX's do
    qb = params_from_numpy(qj, device="cpu")
    prompt = np.random.RandomState(6).randint(1, 32, (2, 6)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, pr: JT.generate(p, jcfg, pr, 6))(
        JQ.quantize_params(jp), to_jax(prompt)))
    np.testing.assert_array_equal(
        TT.generate(qb, tcfg, to_torch(prompt), 6).numpy(), want)


class TorchMoELayer(TNM.Layer):
    """The JAX package's nn.MoE layer (its port is ROADMAP item 6's) as
    a test layer: the MoE FFN over the flattened input, this call's aux
    loss written to the state."""

    def __init__(self, experts, hidden, *, capacity_factor, name):
        self.experts, self.hidden, self.name = experts, hidden, name
        self.capacity_factor = capacity_factor

    def _init(self, rng, spec, _abstract=False):
        params = {} if _abstract else TM.init_moe_params(
            rng, self.experts, spec.shape[-1], self.hidden, device="cpu")
        return params, {"aux_loss": torch.zeros(())}, spec

    def _apply(self, params, state, x, *, training, rng):
        flat = x.reshape(-1, x.shape[-1])
        out = TM.moe_ffn(params, flat, k=2,
                         capacity_factor=self.capacity_factor)
        return out.y.reshape(x.shape), {"aux_loss": out.aux_loss}


def test_trainer_with_aux_loss_weight_trains_an_moe_model_as_jax():
    jmodel = jnn.Sequential([jnn.Dense(16, name="in", activation="relu"),
                             jnn.MoE(4, 32, capacity_factor=4.0, name="moe"),
                             jnn.Dense(4, name="out")])
    tmodel = TNM.Sequential([TNL.Dense(16, name="in", activation="relu"),
                             TorchMoELayer(4, 32, capacity_factor=4.0,
                                           name="moe"),
                             TNL.Dense(4, name="out")])
    jtr = JTR.Trainer(jmodel, loss_fn=lambda lo, y: jnp.mean(
        JL.softmax_cross_entropy(lo[:, 0], y)), optimizer=JO.adam(3e-3),
        aux_loss_weight=0.01)
    ttr = TTR.Trainer(tmodel, loss_fn=lambda lo, y: torch.mean(
        TL.softmax_cross_entropy(lo[:, 0], y)), optimizer=TO.adam(3e-3),
        aux_loss_weight=0.01, device="cpu")
    jstate = jtr.init_state(jnn.ShapeSpec((16, 1, 8)))
    jstate = jstate._replace(
        params=jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                      jstate.params),
        model_state=jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                           jstate.model_state))
    tstate = TS.TrainState.create(
        params_from_numpy(jax.device_get(jstate.params), device="cpu"),
        params_from_numpy(jax.device_get(jstate.model_state), device="cpu"),
        ttr.optimizer)
    rs = np.random.RandomState(0)
    xs = rs.randn(4, 16, 1, 8).astype(np.float32)
    ys = rs.randint(0, 4, (4, 16)).astype(np.int32)
    costs = {"jax": [], "torch": []}

    def handler(side):
        def h(ev):
            if type(ev).__name__ == "EndIteration":
                costs[side].append(float(ev.cost))
        return h

    jstate = jtr.train(jstate, lambda: ((to_jax(x), to_jax(y))
                                        for x, y in zip(xs, ys)),
                       num_passes=6, event_handler=handler("jax"))
    tstate = ttr.train(tstate, lambda: zip(xs, ys), num_passes=6,
                       event_handler=handler("torch"))
    np.testing.assert_allclose(costs["torch"], costs["jax"], rtol=1e-4)
    assert costs["torch"][-1] < costs["torch"][0]
    aux = float(tstate.model_state["moe"]["aux_loss"])
    assert aux > 0 and abs(
        aux - float(jstate.model_state["moe"]["aux_loss"])) <= 1e-4 * aux


# -- MoE in DecodeEngine ------------------------------------------------------


def engine_prompts(lens, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 32, n).astype(np.int32) for n in lens]


def solo_generate(tp, tcfg, prompt, steps):
    out = TT.generate(tp, tcfg, to_torch(prompt)[None, :], steps)
    return out[0, len(prompt):].tolist()


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_moe_pool_matches_generate(kv):
    jcfg, tcfg, jp, tp = models(seed=0, embed_std=0.3)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    eng = DecodeEngine(tp, tcfg, slots=2, max_len=24, page_size=4,
                       device="cpu")
    ps = engine_prompts([5, 8, 4], seed=81)
    got = eng.serve(ps, max_new=8)
    for pr, g in zip(ps, got):
        assert g == solo_generate(tp, tcfg, pr, 8), pr
    if kv == "compute":
        want = np.asarray(jax.jit(lambda p, x: JT.generate(p, jcfg, x, 8))(
            jp, to_jax(ps[1])[None, :]))
        assert got[1] == want[0, 8:].tolist()


def test_moe_buckets_tight_capacity_matches_generate():
    """Bucket pads (prefill) and an inactive slot (decode) claim no
    expert capacity: at capacity_factor 1.0 unmasked padding would evict
    real tokens and the engine would leave generate()'s tokens."""
    jcfg, tcfg, jp, tp = models(seed=0, embed_std=0.3,
                                moe_capacity_factor=1.0)
    eng = DecodeEngine(tp, tcfg, slots=2, max_len=24, page_size=4,
                       device="cpu")
    ps = engine_prompts([4, 9, 6], seed=83)
    got = eng.serve(ps, max_new=6, buckets=(16,))
    jgen = jax.jit(lambda p, x: JT.generate(p, jcfg, x, 6))
    for pr, g in zip(ps, got):
        want = np.asarray(jgen(jp, to_jax(pr)[None, :]))
        assert g == want[0, len(pr):].tolist(), pr
    solo = eng.serve([ps[0]], max_new=6, buckets=(16,))
    assert solo[0] == got[0]
    # the masks are what holds it: pads ahead of the real tokens claim
    # the slots first and evict them when they route
    y = torch.randn(1, 16, 16, generator=torch.Generator().manual_seed(0))
    mask = torch.arange(16)[None, :] >= 12
    blk = tp["blocks"][1]
    with torch.no_grad():
        masked, _ = TT._ffn(tcfg, blk, y, mask)
        alone, _ = TT._ffn(tcfg, blk, y[:, 12:])
        unmasked, _ = TT._ffn(tcfg, blk, y)
    torch.testing.assert_close(masked[:, 12:], alone, atol=1e-6, rtol=0)
    assert not torch.allclose(unmasked[:, 12:], alone, atol=1e-6)


def test_moe_engine_int8_weights_and_speculative_rounds():
    jcfg, tcfg, jp, tp = models(seed=7, embed_std=0.3,
                                moe_capacity_factor=4.0)
    qt = params_from_numpy(jax.device_get(JQ.quantize_params(jp)),
                           device="cpu")
    eng = DecodeEngine(qt, tcfg, slots=2, max_len=32, page_size=4,
                       device="cpu")
    ps = engine_prompts([6, 7, 5], seed=85)
    got = eng.serve(ps, max_new=8)
    for pr, g in zip(ps, got):
        assert g == solo_generate(qt, tcfg, pr, 8), pr
    # speculative verify windows: padding past draft_len claims nothing
    motif = np.tile(np.array([3, 9, 4, 11], np.int32), 3)
    eng = DecodeEngine(tp, tcfg, slots=2, max_len=32, page_size=4,
                       device="cpu")
    ps = [motif, engine_prompts([7], seed=86)[0]]
    plain = eng.serve(ps, max_new=8)
    spec = eng.serve(ps, max_new=8, speculative=True)
    assert spec == plain
    assert eng.last_stats.spec_rounds > 0
