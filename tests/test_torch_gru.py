"""The port's fused GRU time loop against the JAX package's: the plain
forward and backward of `paddle_tpu_torch.ops.fused_gru` (what kernels F
and G compute) against `paddle_tpu.ops.pallas_gru.fused_gru`, which runs
the Pallas kernels in interpret mode on the CPU; `ops.rnn.gru` for every
impl against JAX `rnn.gru(impl="pallas")` and `impl="xla"`; the
bidirectional encoder and `nn.GRU`.

Tolerances: f32 1e-5 on values, 1e-4 relative to the largest magnitude
on gradients (dW sums T*B products); bf16 2e-2 on both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.ops import pallas_gru as JPG
from paddle_tpu.ops import rnn as JR
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.nn import recurrent as TNR
from paddle_tpu_torch.nn.module import ShapeSpec
from paddle_tpu_torch.ops import fused_gru as FG
from paddle_tpu_torch.ops import rnn as TR
from torch_parity import np_f32, to_jax, to_torch

B, T, F, H = 4, 9, 12, 16
LENS = [9, 4, 1, 7]
BOUNDS = {
    "full": [[0, 9]] * 4,
    "ragged": [[0, 9], [0, 4], [0, 1], [0, 7]],
    "reversed": [[0, 9], [5, 9], [8, 9], [2, 9]],
}


def _params(seed=0, f=F, h=H):
    jp = JR.init_gru_params(jax.random.key(seed), f, h)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _close_rel(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    _close(got, want, rel * max(np.abs(want).max(), 1e-30))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", ["full", "ragged", "reversed"])
@pytest.mark.parametrize("initial", [False, True], ids=["h0_zero", "h0"])
def test_fused_gru_op_matches_jax_pallas(dtype, window, initial):
    """fused_gru itself against the Pallas kernels: outputs and the VJP
    of random cotangents for (hs, h_last)."""
    rs = np.random.RandomState(2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xp = np_f32(rs, T, B, 3 * H)
    w = np_f32(rs, H, 3 * H) * 0.3
    h0 = np_f32(rs, B, H) * 0.5 if initial else np.zeros((B, H), np.float32)
    bounds = np.asarray(BOUNDS[window], np.int32)
    dhs, dhl = np_f32(rs, T, B, H), np_f32(rs, B, H)
    jin = (to_jax(xp).astype(jdt), to_jax(w).astype(jdt), to_jax(h0))
    jouts, vjp = jax.vjp(lambda a, b, c: JPG.fused_gru(a, b, c,
                                                       to_jax(bounds)), *jin)
    jgr = vjp((to_jax(dhs), to_jax(dhl)))
    tin = [to_torch(xp).to(tdt), to_torch(w).to(tdt), to_torch(h0)]
    for t in tin:
        t.requires_grad_(True)
    touts = FG.fused_gru(*tin, to_torch(bounds))
    tgr = torch.autograd.grad(touts, tin, (to_torch(dhs), to_torch(dhl)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for j, t in zip(jouts, touts):
        assert t.dtype == torch.float32
        _close(t.detach(), _f32(j), tol)
    for j, t, src in zip(jgr, tgr, tin):
        assert t.dtype == src.dtype
        _close_rel(t.float(), _f32(j), 1e-4 if dtype == "float32" else 2e-2)


def test_dtype_contract():
    """hs is f32 whatever x_proj's dtype; h_last takes h0's dtype; dxp
    x_proj's, dW w_hh's, dh0 h0's."""
    rs = np.random.RandomState(3)
    xp = to_torch(np_f32(rs, T, B, 3 * H)).bfloat16().requires_grad_(True)
    w = to_torch(np_f32(rs, H, 3 * H) * 0.3).bfloat16().requires_grad_(True)
    h0 = torch.zeros(B, H, dtype=torch.float64, requires_grad=True)
    bounds = FG.make_bounds(B, T, to_torch(np.asarray(LENS)), False)
    hs, h_last = FG.fused_gru(xp, w, h0, bounds)
    assert hs.dtype == torch.float32 and h_last.dtype == torch.float64
    dxp, dw, dh0 = torch.autograd.grad((hs.sum() + h_last.sum()),
                                       (xp, w, h0))
    assert (dxp.dtype, dw.dtype, dh0.dtype) == (torch.bfloat16,
                                                torch.bfloat16, torch.float64)
    dxp, dw, dh0 = FG.gru_backward_reference(
        xp.detach(), w.detach(), h0.detach(), bounds, hs.detach(),
        torch.ones_like(hs), torch.zeros(B, H))
    assert (dxp.dtype, dw.dtype, dh0.dtype) == (torch.bfloat16,
                                                torch.float32, torch.float32)


def _gru_both(impl, reverse, lengths, initial, jax_impl):
    """Outputs, final state and gradients of one seeded loss through JAX's
    rnn.gru and the port's."""
    rs = np.random.RandomState(1)
    jp, tp = _params()
    x = np_f32(rs, B, T, F)
    w_o, w_h = np_f32(rs, B, T, H), np_f32(rs, B, H)
    h0 = np_f32(rs, B, H) * 0.5 if initial else None
    lens = None if lengths is None else np.asarray(lengths, np.int32)

    def jloss(p, x, h0):
        o, fin = JR.gru(p, x, None if lens is None else to_jax(lens),
                        initial_state=h0, reverse=reverse, impl=jax_impl)
        return jnp.sum(o * w_o) + jnp.sum(fin * w_h), (o, fin)

    argnums = (0, 1, 2) if initial else (0, 1)
    (_, jout), jg = jax.value_and_grad(jloss, argnums=argnums, has_aux=True)(
        jp, to_jax(x), None if h0 is None else to_jax(h0))
    tx = to_torch(x).requires_grad_(True)
    leaves = [tp["w_ih"], tp["w_hh"], tp["b"]]
    for t in leaves:
        t.requires_grad_(True)
    wrt = [tx] + leaves
    th0 = None
    if initial:
        th0 = to_torch(h0).requires_grad_(True)
        wrt.append(th0)
    o, fin = TR.gru(tp, tx, None if lens is None else to_torch(lens),
                    initial_state=th0, reverse=reverse, impl=impl)
    loss = torch.sum(o * to_torch(w_o)) + torch.sum(fin * to_torch(w_h))
    tg = torch.autograd.grad(loss, wrt)
    jgl = [jg[1], jg[0]["w_ih"], jg[0]["w_hh"], jg[0]["b"]]
    if initial:
        jgl.append(jg[2])
    return jout, (o.detach(), fin.detach()), jgl, tg


@pytest.mark.parametrize("impl,jax_impl", [(None, "pallas"),
                                           ("torch", "pallas"),
                                           ("scan", "xla")])
@pytest.mark.parametrize("case", [
    dict(reverse=False, lengths=None, initial=False),
    dict(reverse=False, lengths=LENS, initial=False),
    dict(reverse=True, lengths=LENS, initial=False),
    dict(reverse=True, lengths=None, initial=True),
], ids=["full", "ragged", "reverse_ragged", "reverse_initial"])
def test_gru_matches_jax(impl, jax_impl, case):
    jout, tout, jg, tg = _gru_both(impl, jax_impl=jax_impl, **case)
    for j, t in zip(jout, tout):
        _close(t, j, 1e-5)
    for j, t in zip(jg, tg):
        assert t.shape == tuple(j.shape)
        _close_rel(t, j)
    if case["lengths"] is not None:
        assert float(tout[0][2, 1:].abs().sum()) == 0.0


def test_bidirectional_gru_matches_jax():
    """The seq2seq encoder: bidirectional(gru) on ragged lengths."""
    rs = np.random.RandomState(4)
    jf, tf = _params(seed=1)
    jb, tb = _params(seed=2)
    x = np_f32(rs, B, T, F)
    lens = np.asarray(LENS, np.int32)
    jo, (jhf, jhb) = JR.bidirectional(JR.gru, jf, jb, to_jax(x),
                                      to_jax(lens), impl="pallas")
    to, (thf, thb) = TR.bidirectional(TR.gru, tf, tb, to_torch(x),
                                      to_torch(lens))
    assert to.shape == (B, T, 2 * H)
    for j, t in ((jo, to), (jhf, thf), (jhb, thb)):
        _close(t, j, 1e-5)


def test_gru_layer_matches_jax(monkeypatch):
    """nn.GRU on ragged lengths; JAX's layer is forced onto its Pallas
    kernels with its environment override."""
    monkeypatch.setenv("PADDLE_TPU_RNN_IMPL", "pallas")
    rs = np.random.RandomState(5)
    x = np_f32(rs, B, T, F)
    lens = np.asarray(LENS, np.int32)
    jl = jnn.GRU(H, reverse=True)
    jp, js = jl.init(jax.random.key(6), jnn.ShapeSpec(x.shape))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    w_o = np_f32(rs, B, T, H)

    def jloss(p):
        return jnp.sum(jl.apply(p, js, to_jax(x), to_jax(lens))[0] * w_o)

    jval, jg = jax.value_and_grad(jloss)(jp)
    tl = TNR.GRU(H, reverse=True)
    assert tl.out_spec(ShapeSpec(x.shape)).shape == (B, T, H)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    leaves = [tp[k] for k in ("w_ih", "w_hh", "b")]
    for t in leaves:
        t.requires_grad_(True)
    out, _ = tl.apply(tp, {}, to_torch(x), to_torch(lens))
    loss = torch.sum(out * to_torch(w_o))
    assert abs(loss.item() - float(jval)) <= 1e-4 * max(1.0, abs(float(jval)))
    for t, k in zip(torch.autograd.grad(loss, leaves), ("w_ih", "w_hh", "b")):
        _close_rel(t, jg[k])
    params, _ = TNR.GRU(H).init(0, ShapeSpec(x.shape), device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "w_ih": (F, 3 * H), "w_hh": (H, 3 * H), "b": (3 * H,)}


def test_gru_step_matches_jax():
    rs = np.random.RandomState(9)
    jp, tp = _params(seed=2)
    x, h = np_f32(rs, B, F), np_f32(rs, B, H)
    _close(TR.gru_step(tp, to_torch(x), to_torch(h)),
           JR.gru_step(jp, to_jax(x), to_jax(h)), 1e-5)


def test_dispatch_on_cpu_runs_plain_versions_and_counts_nothing():
    _, tp = _params()
    x = torch.randn(B, T, F)
    FG.reset_launch_counts()
    o_none, _ = TR.gru(tp, x)
    o_torch, _ = TR.gru(tp, x, impl="torch")
    assert torch.equal(o_none, o_torch)
    assert FG.launch_counts == {"fwd": 0, "bwd": 0}
    with pytest.raises(ValueError, match="CUDA tensors only"):
        TR.gru(tp, x, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        TR.gru(tp, x, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        TNR.GRU(H, impl="xla")


def test_kernel_path_refuses_shapes_it_does_not_take():
    """A shape the kernels do not take raises ValueError naming the limit,
    on CPU tensors too (the shape checks come before the device check)."""
    _, tp = _params(h=6)
    with pytest.raises(ValueError, match="multiple of 4"):
        TR.gru(tp, torch.randn(B, T, F), impl="kernel")
    xp = torch.randn(T, B, 3 * H)
    bounds = FG.make_bounds(B, T, None, False)
    with pytest.raises(ValueError, match="w_hh"):
        FG.gru_forward_kernel(xp, torch.randn(H, 4 * H), torch.zeros(B, H),
                              bounds)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FG.gru_forward_kernel(xp.double(), torch.randn(H, 3 * H),
                              torch.zeros(B, H), bounds)


def test_kernel_geometry_and_limits():
    """The launch geometry on an H100 (132 SMs, 227 KB opt-in shared
    memory) at the seq2seq encoder's and generation's shapes, and the
    shapes it refuses."""
    sms, smem = 132, 232448
    for (b, h), (hb, threads) in {(64, 512): (4, 256), (16, 512): (4, 64),
                                  (64, 256): (2, 128), (128, 512): (4, 512),
                                  (4, 16): (1, 32)}.items():
        for backward in (False, True):
            g = FG.geometry(b, h, sms, smem, backward=backward)
            assert g[:2] == (hb, threads)
            assert h // g[0] <= sms and g[3] <= smem and g[2] <= h
    # all of h in one tile at the encoder's shape, forward and backward
    assert FG.geometry(64, 512, sms, smem, backward=False)[2] == 512
    assert FG.geometry(64, 512, sms, smem, backward=True)[2] == 512
    with pytest.raises(ValueError, match="pairs"):
        FG.geometry(1024, 1024, sms, smem, backward=False)
    with pytest.raises(ValueError, match="shared memory"):
        FG.geometry(64, 2048, sms, smem, backward=True)
