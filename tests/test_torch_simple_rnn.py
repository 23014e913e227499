"""The port's fused tanh-RNN time loop against the JAX package's: the
plain forward and backward of `paddle_tpu_torch.ops.fused_rnn` (what
kernels H and I compute) against `paddle_tpu.ops.pallas_rnn
.fused_simple_rnn`, which runs the Pallas kernels in interpret mode on
the CPU, and `ops.rnn.simple_rnn` for every impl against JAX
`simple_rnn(impl="pallas")` and `impl="xla"`.

Tolerances: f32 1e-5 on values, 1e-4 relative to the largest magnitude
on gradients; bf16 2e-2 on both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_rnn as JPR
from paddle_tpu.ops import rnn as JR
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.ops import fused_rnn as FR
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
    jp = JR.init_rnn_params(jax.random.key(seed), f, h)
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
def test_fused_simple_rnn_op_matches_jax_pallas(dtype, window, initial):
    rs = np.random.RandomState(2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xp = np_f32(rs, T, B, H)
    w = np_f32(rs, H, H) * 0.3
    h0 = np_f32(rs, B, H) * 0.5 if initial else np.zeros((B, H), np.float32)
    bounds = np.asarray(BOUNDS[window], np.int32)
    dhs, dhl = np_f32(rs, T, B, H), np_f32(rs, B, H)
    jin = (to_jax(xp).astype(jdt), to_jax(w).astype(jdt), to_jax(h0))
    jouts, vjp = jax.vjp(
        lambda a, b, c: JPR.fused_simple_rnn(a, b, c, to_jax(bounds)), *jin)
    jgr = vjp((to_jax(dhs), to_jax(dhl)))
    tin = [to_torch(xp).to(tdt), to_torch(w).to(tdt), to_torch(h0)]
    for t in tin:
        t.requires_grad_(True)
    touts = FR.fused_simple_rnn(*tin, to_torch(bounds))
    tgr = torch.autograd.grad(touts, tin, (to_torch(dhs), to_torch(dhl)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for j, t in zip(jouts, touts):
        assert t.dtype == torch.float32
        _close(t.detach(), _f32(j), tol)
    for j, t, src in zip(jgr, tgr, tin):
        assert t.dtype == src.dtype
        _close_rel(t.float(), _f32(j), 1e-4 if dtype == "float32" else 2e-2)


def test_dtype_contract():
    """hs is f32 whatever x_proj's dtype; dxp takes x_proj's dtype, dW
    w_hh's (f32 from the plain version), dh0 h0's."""
    rs = np.random.RandomState(3)
    xp = to_torch(np_f32(rs, T, B, H)).bfloat16().requires_grad_(True)
    w = to_torch(np_f32(rs, H, H) * 0.3).bfloat16().requires_grad_(True)
    h0 = torch.zeros(B, H, requires_grad=True)
    bounds = FR.make_bounds(B, T, to_torch(np.asarray(LENS)), True)
    hs, h_last = FR.fused_simple_rnn(xp, w, h0, bounds)
    assert hs.dtype == torch.float32 and h_last.dtype == torch.float32
    dxp, dw, dh0 = torch.autograd.grad(hs.sum(), (xp, w, h0))
    assert (dxp.dtype, dw.dtype, dh0.dtype) == (torch.bfloat16,
                                                torch.bfloat16, torch.float32)
    _, dw_f, _ = FR.rnn_backward_reference(
        xp.detach(), w.detach(), h0.detach(), bounds, hs.detach(),
        torch.ones_like(hs), torch.zeros(B, H))
    assert dw_f.dtype == torch.float32


@pytest.mark.parametrize("impl,jax_impl", [(None, "pallas"),
                                           ("torch", "pallas"),
                                           ("scan", "xla")])
@pytest.mark.parametrize("reverse,lengths", [(False, None), (False, LENS),
                                             (True, LENS)],
                         ids=["full", "ragged", "reverse_ragged"])
def test_simple_rnn_matches_jax(impl, jax_impl, reverse, lengths):
    rs = np.random.RandomState(1)
    jp, tp = _params()
    x = np_f32(rs, B, T, F)
    w_o, w_h = np_f32(rs, B, T, H), np_f32(rs, B, H)
    lens = None if lengths is None else np.asarray(lengths, np.int32)

    def jloss(p, x):
        o, fin = JR.simple_rnn(p, x, None if lens is None else to_jax(lens),
                               reverse=reverse, impl=jax_impl)
        return jnp.sum(o * w_o) + jnp.sum(fin * w_h), (o, fin)

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                       has_aux=True)(jp, to_jax(x))
    tx = to_torch(x).requires_grad_(True)
    leaves = [tp["w_ih"], tp["w_hh"], tp["b"]]
    for t in leaves:
        t.requires_grad_(True)
    o, fin = TR.simple_rnn(tp, tx, None if lens is None else to_torch(lens),
                           reverse=reverse, impl=impl)
    loss = torch.sum(o * to_torch(w_o)) + torch.sum(fin * to_torch(w_h))
    tg = torch.autograd.grad(loss, [tx] + leaves)
    _close(o.detach(), jout[0], 1e-5)
    _close(fin.detach(), jout[1], 1e-5)
    for j, t in zip([jg[1], jg[0]["w_ih"], jg[0]["w_hh"], jg[0]["b"]], tg):
        _close_rel(t, j)


def test_non_tanh_activation():
    """The fused loop computes tanh only: with another activation impl
    None takes the scan (JAX "auto"), and "kernel" or "torch" raise."""
    rs = np.random.RandomState(7)
    jp, tp = _params()
    x = np_f32(rs, B, T, F)
    lens = np.asarray(LENS, np.int32)
    jo, jfin = JR.simple_rnn(jp, to_jax(x), to_jax(lens),
                             activation=jax.nn.relu, impl="xla")
    to, tfin = TR.simple_rnn(tp, to_torch(x), to_torch(lens),
                             activation=torch.relu)
    _close(to, jo, 1e-5)
    _close(tfin, jfin, 1e-5)
    for impl in ("kernel", "torch"):
        with pytest.raises(ValueError, match="only tanh"):
            TR.simple_rnn(tp, to_torch(x), activation=torch.relu, impl=impl)


def test_dispatch_on_cpu_runs_plain_versions_and_counts_nothing():
    _, tp = _params()
    x = torch.randn(B, T, F)
    FR.reset_launch_counts()
    o_none, _ = TR.simple_rnn(tp, x)
    o_torch, _ = TR.simple_rnn(tp, x, impl="torch")
    assert torch.equal(o_none, o_torch)
    assert FR.launch_counts == {"fwd": 0, "bwd": 0}
    with pytest.raises(ValueError, match="CUDA tensors only"):
        TR.simple_rnn(tp, x, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        TR.simple_rnn(tp, x, impl="xla")


def test_kernel_path_refuses_shapes_it_does_not_take():
    _, tp = _params(h=10)
    with pytest.raises(ValueError, match="multiple of 4"):
        TR.simple_rnn(tp, torch.randn(B, T, F), impl="kernel")
    bounds = FR.make_bounds(B, T, None, False)
    with pytest.raises(ValueError, match="h0"):
        FR.rnn_forward_kernel(torch.randn(T, B, H), torch.randn(H, H),
                              torch.zeros(B + 1, H), bounds)


def test_kernel_geometry_and_limits():
    """The launch geometry on an H100 (132 SMs, 227 KB opt-in shared
    memory) at the RNN benchmark's shape, and the shapes it refuses."""
    sms, smem = 132, 232448
    for backward in (False, True):
        hb, threads, width, used = FR.geometry(64, 512, sms, smem,
                                               backward=backward)
        assert (hb, threads, width) == (4, 256, 512) and used <= smem
    assert FR.geometry(4, 16, sms, smem, backward=True)[:3] == (1, 32, 16)
    with pytest.raises(ValueError, match="pairs"):
        FR.geometry(2048, 512, sms, smem, backward=False)
    with pytest.raises(ValueError, match="shared memory"):
        FR.geometry(64, 4096, sms, smem, backward=True)


def test_init_rnn_params_shapes_and_scales():
    p = TR.init_rnn_params(0, F, H)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_ih": (F, H), "w_hh": (H, H), "b": (H,)}
    assert float(p["w_ih"].abs().max()) <= 1.0 / np.sqrt(F)
    assert float(p["w_hh"].abs().max()) <= 1.0 / np.sqrt(H)
    assert float(p["b"].abs().max()) == 0.0
