"""The port's single-device mixture-of-experts (`parallel/moe.py`) held
against the live JAX package on the same weights and router logits:
the routing decisions (expert, slot, keep) exactly -- ties included,
since they decide which expert computes a token -- gates, aux loss and
dropped fraction at f32 rounding, both dispatches, `moe_ffn` and
`expert_choice_ffn` with their gradients (f32, 1e-5 of each leaf's
scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import moe as JM
from paddle_tpu_torch import parallel as TPAR
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.parallel import moe as TM
from torch_parity import assert_tree_close, rel_err, to_jax, to_torch

TOL = 1e-5


def logits_np(t, e, seed, ties=False):
    rs = np.random.RandomState(seed)
    if ties:
        # small integers: exact ties within a row and across rows
        return rs.randint(0, 3, (t, e)).astype(np.float32)
    return rs.standard_normal((t, e)).astype(np.float32)


def mask_np(t, seed):
    return np.random.RandomState(seed + 100).rand(t) > 0.3


def moe_params(e, d, f, seed):
    jp = JM.init_moe_params(jax.random.key(seed), e, d, f)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jp)
    # non-zero biases so their gradients and sums are exercised
    rs = np.random.RandomState(seed)
    jp["b1"] = jnp.asarray(0.1 * rs.standard_normal((e, f)), jnp.float32)
    jp["b2"] = jnp.asarray(0.1 * rs.standard_normal((e, d)), jnp.float32)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def assert_routing_equal(got, want):
    np.testing.assert_array_equal(got.expert.numpy(), np.asarray(want.expert))
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want.slot))
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    np.testing.assert_allclose(got.gate.numpy(), np.asarray(want.gate),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got.dropped), float(want.dropped),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("k,capacity,ties,masked", [
    (1, 4, False, False), (2, 4, False, False), (2, 8, False, True),
    (3, 4, False, True), (2, 4, True, False), (2, 3, True, True),
])
def test_top_k_routing_matches_jax(k, capacity, ties, masked):
    t, e = 24, 4
    lg = logits_np(t, e, seed=k + capacity, ties=ties)
    mask = mask_np(t, k) if masked else None
    want = JM.top_k_routing(to_jax(lg), k, capacity,
                            token_mask=None if mask is None else to_jax(mask))
    got = TM.top_k_routing(to_torch(lg), k, capacity,
                           token_mask=None if mask is None else to_torch(mask))
    assert_routing_equal(got, want)
    assert np.asarray(want.keep).sum() < k * (
        t if mask is None else mask.sum())   # capacity really drops


def test_top_k_routing_jitter_with_jax_draws():
    t, e, jitter = 16, 4, 0.1
    lg = logits_np(t, e, seed=3)
    key = jax.random.key(5)
    want = JM.top_k_routing(to_jax(lg), 2, 8, rng=key, jitter=jitter)
    noise = jax.random.uniform(key, (t, e), jnp.float32, 1.0 - jitter,
                               1.0 + jitter)
    got = TM.top_k_routing(to_torch(lg), 2, 8, jitter=jitter,
                           jitter_noise=to_torch(noise))
    assert_routing_equal(got, want)
    # the port's own draws land in the same band
    g = torch.Generator().manual_seed(0)
    drawn = TM.top_k_routing(to_torch(lg), 2, 8, rng=g, jitter=jitter)
    assert drawn.expert.shape == (2, t)


def test_pads_claim_no_capacity():
    t, e, cap = 8, 2, 4
    lg = np.tile(np.array([[5.0, -5.0]], np.float32), (t, 1))
    mask = np.arange(t) >= 4
    jd, jc, jaux, jdrop = JM.top_k_gating(to_jax(lg), 1, cap,
                                          token_mask=to_jax(mask))
    td, tc, taux, tdrop = TM.top_k_gating(to_torch(lg), 1, cap,
                                          token_mask=to_torch(mask))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-7)
    assert float(td[4:, 0].sum()) == 4.0 and float(td[:4].sum()) == 0.0
    assert float(tdrop) == float(jdrop) == 0.0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("ties,masked", [(False, False), (True, False),
                                         (True, True), (False, True)])
def test_expert_choice_routing_matches_jax(ties, masked):
    t, e, cap = 20, 4, 6
    lg = logits_np(t, e, seed=11, ties=ties)
    mask = mask_np(t, 2) if masked else None
    want = JM.expert_choice_routing(
        to_jax(lg), cap, token_mask=None if mask is None else to_jax(mask))
    got = TM.expert_choice_routing(
        to_torch(lg), cap, token_mask=None if mask is None else to_torch(mask))
    np.testing.assert_array_equal(got.token_idx.numpy(),
                                  np.asarray(want.token_idx))
    np.testing.assert_allclose(got.gate.numpy(), np.asarray(want.gate),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(float(got.dropped), float(want.dropped),
                               atol=1e-7)


def test_capacity_and_dispatch_choice_match_jax():
    for n, e, cf, k in [(1, 4, 1.25, 2), (16376, 8, 1.25, 2), (7, 3, 2.0, 1),
                        (100, 8, 0.5, 2), (33, 5, 1.0, 3)]:
        assert TM.capacity_for(n, e, cf, k) == JM.capacity_for(n, e, cf, k)
    assert TM._EINSUM_DISPATCH_MAX == JM._EINSUM_DISPATCH_MAX
    for args in [("auto", 16376, 8, 5120), ("auto", 64, 4, 40),
                 ("einsum", 16376, 8, 5120), ("scatter", 8, 2, 4)]:
        assert TM._use_scatter(*args) == JM._use_scatter(*args)
    with pytest.raises(ValueError, match="dispatch_impl"):
        TM._use_scatter("dense", 8, 2, 4)


@pytest.mark.parametrize("k,cf,masked", [(2, 1.0, False), (1, 0.75, True),
                                         (2, 1.25, True)])
def test_dispatches_match_jax(k, cf, masked):
    t, e, d = 20, 4, 8
    rs = np.random.RandomState(k)
    x = rs.standard_normal((t, d)).astype(np.float32)
    lg = logits_np(t, e, seed=21 + k)
    mask = mask_np(t, k) if masked else None
    cap = JM.capacity_for(t, e, cf, k)
    jr = JM.top_k_routing(to_jax(lg), k, cap,
                          token_mask=None if mask is None else to_jax(mask))
    tr = TM.top_k_routing(to_torch(lg), k, cap,
                          token_mask=None if mask is None else to_torch(mask))
    j_sc = JM.scatter_dispatch(jr, to_jax(x), e, cap)
    t_sc = TM.scatter_dispatch(tr, to_torch(x), e, cap)
    np.testing.assert_array_equal(t_sc.numpy(), np.asarray(j_sc))
    j_ein, j_comb = JM._dispatch_expert_in(jr, to_jax(x), e, cap, "einsum")
    t_ein, t_comb = TM._dispatch_expert_in(tr, to_torch(x), e, cap, "einsum")
    np.testing.assert_allclose(t_ein.numpy(), np.asarray(j_ein), atol=1e-6)
    np.testing.assert_allclose(t_comb.numpy(), np.asarray(j_comb), atol=1e-7)
    out = rs.standard_normal((e, cap, d)).astype(np.float32)
    jg = JM.gather_combine(jr, to_jax(out), cap)
    tg = TM.gather_combine(tr, to_torch(out), cap)
    te = TM._combine_out(tr, t_comb, to_torch(out), cap)
    assert rel_err(tg, np.asarray(jg)) <= TOL
    assert rel_err(te, np.asarray(jg)) <= TOL


def jax_value_and_grads(fn, jp, x, cot):
    def f(p, x):
        out = fn(p, x)
        return jnp.sum(out.y * cot) + 0.3 * out.aux_loss, out
    (val, out), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jp, x)
    return out, gp, gx


def torch_value_and_grads(fn, tp, x, cot):
    leaves = [tp["router"]["kernel"], tp["w1"], tp["b1"], tp["w2"], tp["b2"]]
    for leaf in leaves:
        leaf.requires_grad_(True)
    x = x.clone().requires_grad_(True)
    out = fn(tp, x)
    val = torch.sum(out.y * cot) + 0.3 * out.aux_loss
    grads = torch.autograd.grad(val, leaves + [x])
    gp = {"router": {"kernel": grads[0]}, "w1": grads[1], "b1": grads[2],
          "w2": grads[3], "b2": grads[4]}
    return out, gp, grads[5]


@pytest.mark.parametrize("impl,k,cf,masked", [
    ("einsum", 2, 0.5, False), ("scatter", 2, 0.5, False),
    ("scatter", 2, 1.25, True), ("auto", 1, 0.75, True)])
def test_moe_ffn_and_gradients_match_jax(impl, k, cf, masked):
    t, e, d, f = 24, 4, 8, 16
    jp, tp = moe_params(e, d, f, seed=k)
    rs = np.random.RandomState(30 + k)
    x = rs.standard_normal((t, d)).astype(np.float32)
    cot = rs.standard_normal((t, d)).astype(np.float32)
    mask = mask_np(t, k) if masked else None
    jm = None if mask is None else to_jax(mask)
    tm = None if mask is None else to_torch(mask)
    jout, jgp, jgx = jax_value_and_grads(
        lambda p, x: JM.moe_ffn(p, x, k=k, capacity_factor=cf,
                                token_mask=jm, dispatch_impl=impl),
        jp, to_jax(x), to_jax(cot))
    tout, tgp, tgx = torch_value_and_grads(
        lambda p, x: TM.moe_ffn(p, x, k=k, capacity_factor=cf,
                                token_mask=tm, dispatch_impl=impl),
        tp, to_torch(x), to_torch(cot))
    assert rel_err(tout.y, np.asarray(jout.y)) <= TOL
    np.testing.assert_allclose(tout.aux_loss.item(), float(jout.aux_loss),
                               rtol=1e-6)
    assert float(tout.dropped) == pytest.approx(float(jout.dropped), abs=1e-7)
    assert float(jout.dropped) > 0 or cf > 1.0     # drops are exercised
    assert_tree_close(tgp, jax.device_get(jgp), TOL)
    assert rel_err(tgx, np.asarray(jgx)) <= TOL


@pytest.mark.parametrize("t,cf,masked", [(24, 2.0, False), (24, 1.0, True),
                                         (3, 2.0, False)])
def test_expert_choice_ffn_and_gradients_match_jax(t, cf, masked):
    e, d, f = 4, 8, 16
    jp, tp = moe_params(e, d, f, seed=7)
    rs = np.random.RandomState(40 + t)
    x = rs.standard_normal((t, d)).astype(np.float32)
    cot = rs.standard_normal((t, d)).astype(np.float32)
    mask = mask_np(t, 3) if masked else None
    jm = None if mask is None else to_jax(mask)
    tm = None if mask is None else to_torch(mask)
    jout, jgp, jgx = jax_value_and_grads(
        lambda p, x: JM.expert_choice_ffn(p, x, capacity_factor=cf,
                                          token_mask=jm),
        jp, to_jax(x), to_jax(cot))
    tout, tgp, tgx = torch_value_and_grads(
        lambda p, x: TM.expert_choice_ffn(p, x, capacity_factor=cf,
                                          token_mask=tm),
        tp, to_torch(x), to_torch(cot))
    assert rel_err(tout.y, np.asarray(jout.y)) <= TOL
    assert float(tout.aux_loss) == float(jout.aux_loss) == 0.0
    assert float(tout.dropped) == pytest.approx(float(jout.dropped), abs=1e-7)
    assert_tree_close(tgp, jax.device_get(jgp), TOL)
    assert rel_err(tgx, np.asarray(jgx)) <= TOL


def test_init_moe_params_tree_and_distributions_match_jax():
    e, d, f = 4, 16, 32
    jp = jax.device_get(JM.init_moe_params(jax.random.key(0), e, d, f))
    tp = TM.init_moe_params(np.random.RandomState(0), e, d, f, device="cpu")
    j_leaves = jax.tree_util.tree_leaves_with_path(jp)
    t_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda a: a.numpy(), tp))
    assert [p for p, _ in j_leaves] == [p for p, _ in t_leaves]
    for (path, a), (_, b) in zip(j_leaves, t_leaves):
        assert a.shape == b.shape and b.dtype == np.float32, path
    assert float(tp["w1"].abs().max()) <= 1 / np.sqrt(d)
    assert float(tp["w2"].abs().max()) <= 1 / np.sqrt(f)
    assert abs(float(tp["router"]["kernel"].std()) - 0.02) < 0.005
    assert not torch.equal(tp["w1"][0], tp["w1"][1])   # a draw per expert
    if not torch.cuda.is_available():    # device None means cuda
        with pytest.raises(RuntimeError, match="CUDA"):
            TM.init_moe_params(0, e, d, f)


def test_expert_parallel_pieces_raise_naming_the_distributed_slice():
    """The expert-parallel pieces came with the distributed slice
    (tests/test_torch_moe_ep.py holds them against JAX): exported beside
    the single-device FFN, and shard_moe_params refuses an expert count
    the model axis does not divide before it places anything."""
    import types

    assert "shard_moe_params" in TPAR.__all__
    assert "make_expert_parallel_ffn" in TPAR.__all__
    assert TPAR.moe_ffn is TM.moe_ffn
    mesh = types.SimpleNamespace(shape={"model": 3})
    with pytest.raises(ValueError, match="4 experts not divisible by "
                                         "model axis size 3"):
        TM.shard_moe_params({"w1": torch.zeros(4, 2, 2)}, mesh)
