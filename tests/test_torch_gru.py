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
from paddle_tpu_torch.ops import time_loop as TL
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
    shapes it refuses: F's and G's serial loops (row groups x unit
    groups)."""
    sms, smem = 132, 232448
    for (b, h), (rows, units) in {(64, 512): (8, 16), (16, 512): (4, 32),
                                  (64, 256): (16, 8), (128, 512): (8, 16),
                                  (4, 16): (1, 16)}.items():
        g = FG.geometry(b, h, sms, smem)
        assert (g.row_groups, g.unit_groups) == (rows, units)
        assert g.ctas <= sms and g.smem <= smem and g.chunk <= h
        assert g.resident and g.br * g.hb <= g.threads * g.rep
        g = FG.backward_geometry(b, h, sms, smem)
        assert g.ctas <= sms and g.smem <= smem
        assert g.br * g.hb <= g.threads * g.rep and g.threads <= 768
    # all of h in one chunk at the encoder's shape
    assert FG.geometry(64, 512, sms, smem).chunk == 512
    # G at the encoder's shape: 8 row groups x 16 unit groups, the whole
    # operand row in one chunk of 512 columns at a time
    assert tuple(FG.backward_geometry(64, 512, sms, smem)[:7]) == (
        8, 16, 32, 8, 4, 256, 512)
    # H=1024 at B=64, refused before, now fits in two row groups
    assert FG.backward_geometry(64, 1024, sms, smem).row_groups == 2
    with pytest.raises(ValueError, match="pairs"):
        FG.geometry(1024, 1024, sms, smem)
    # H=2048 at B=64: w_hh read from global memory, two pairs per thread
    # in G and four in F (refused by the one-launch F); H=8192 is refused
    g = FG.backward_geometry(64, 2048, sms, smem)
    assert not g.resident and g.rep == 2
    g = FG.geometry(64, 2048, sms, smem)
    assert not g.resident and g.rep == 4
    with pytest.raises(ValueError, match="pairs per CTA"):
        FG.backward_geometry(64, 8192, sms, smem)


def test_training_step_refuses_a_shape_g_does_not_take_before_f_runs(
        monkeypatch):
    """With gradients wanted, `fused_gru` checks G's geometry before it
    launches F, so a training step fails at its start and not in its
    backward. The card's limits and the inputs' check are stood in for
    (no card here); B=20000 at H=512 has no grid of G's loop."""
    monkeypatch.setattr(FG, "_limits", lambda device: (132, 232448))
    monkeypatch.setattr(TL, "check_inputs", lambda *a: (T, 20000, 512))

    def no_f(*a):
        raise AssertionError("F launched before G's geometry was checked")

    monkeypatch.setattr(FG, "gru_forward_kernel", no_f)
    xp = torch.zeros(T, B, 3 * H, requires_grad=True)
    w = torch.zeros(H, 3 * H, requires_grad=True)
    bounds = FG.make_bounds(B, T, None, False)
    with pytest.raises(ValueError, match="pairs per CTA"):
        FG.fused_gru(xp, w, torch.zeros(B, H), bounds, impl="kernel")
    # without gradients only F runs, and G's geometry is not asked
    with pytest.raises(AssertionError, match="F launched"):
        FG.fused_gru(xp.detach(), w.detach(), torch.zeros(B, H), bounds,
                     impl="kernel")


def _three_phase_backward(x_proj, w_hh, h0, bounds, hs, dhs, dh_last):
    """Kernel G's schedule (csrc/fused_gru.cu) written out in plain
    PyTorch: (1) r, z, n and hn of every step at once from round_w(hprev)
    @ w_hh; (2) the serial loop with only the carry's product in it,
    which stores the operand dhp = [dgr, dgz, dgn * r] in w_hh's dtype;
    (3) dW_hh = round_w(hprev)^T @ dhp over all T*B rows, split over the
    rows as the kernel splits them and summed in order. Returns (dxp, dW,
    dh0, dhp)."""
    steps, b, g3 = x_proj.shape
    h = g3 // 3
    wd, w = w_hh.dtype, w_hh.float()
    hprev_f = torch.cat([h0.float()[None], hs[:-1].float()])
    hprev = TL.operand(hprev_f, wd)
    hp = (hprev.reshape(-1, h) @ w).reshape(steps, b, g3)
    xp = x_proj.float()
    hn = hp[..., 2 * h:]
    r = torch.sigmoid(xp[..., :h] + hp[..., :h])
    z = torch.sigmoid(xp[..., h:2 * h] + hp[..., h:2 * h])
    n = torch.tanh(xp[..., 2 * h:] + r * hn)
    opnd = torch.empty((steps, b, g3), dtype=wd)
    dxp = torch.empty_like(x_proj)
    dh_c = dh_last.float()
    for t in reversed(range(steps)):
        dh = dhs[t].float() + dh_c
        dz = dh * (hprev_f[t] - n[t])
        dgn = dh * (1.0 - z[t]) * (1.0 - n[t] * n[t])
        dgz = dz * z[t] * (1.0 - z[t])
        dgr = dgn * hn[t] * r[t] * (1.0 - r[t])
        m = TL.live(bounds, t)
        d = torch.where(m, torch.cat([dgr, dgz, dgn], dim=-1), 0.0)
        dxp[t] = d.to(dxp.dtype)
        opnd[t] = torch.cat([d[:, :2 * h], d[:, 2 * h:] * r[t]],
                            dim=-1).to(wd)
        dh_c = torch.where(m, dh * z[t] + opnd[t].float() @ w.T, dh)
    splits, chunk = TL.dw_splits(steps * b, h, 3, 132)
    rows_h, rows_o = hprev.reshape(-1, h), opnd.reshape(-1, g3).float()
    dw = torch.zeros(h, g3)
    for q in range(splits):
        sl = slice(q * chunk, (q + 1) * chunk)
        dw = dw + rows_h[sl].T @ rows_o[sl]
    return dxp, dw, dh_c, opnd


_PHASE_CASES = {
    "full": ("float32", "float32", "full", False),
    "ragged": ("float32", "float32", "ragged", False),
    "reversed": ("float32", "float32", "reversed", False),
    "nonzero_h0": ("float32", "float32", "ragged", True),
    "bf16_x_proj": ("bfloat16", "float32", "ragged", True),
    "bf16_both": ("bfloat16", "bfloat16", "reversed", True),
}


def _phase_inputs(x_dtype, w_dtype, window, initial, seed=12):
    """Seeded inputs of one backward call: numpy arrays, then the port's
    tensors with the plain forward's hs."""
    rs = np.random.RandomState(seed)
    xp, w = np_f32(rs, T, B, 3 * H), np_f32(rs, H, 3 * H) * 0.3
    h0 = np_f32(rs, B, H) * 0.5 if initial else np.zeros((B, H), np.float32)
    dhs, dhl = np_f32(rs, T, B, H), np_f32(rs, B, H)
    bounds = np.asarray(BOUNDS[window], np.int32)
    xdt, wdt = getattr(torch, x_dtype), getattr(torch, w_dtype)
    t_in = (to_torch(xp).to(xdt), to_torch(w).to(wdt), to_torch(h0),
            to_torch(bounds))
    hs = FG.gru_forward_reference(*t_in)
    return ((xp, w, h0, bounds, dhs, dhl),
            t_in + (hs, to_torch(dhs), to_torch(dhl)))


@pytest.mark.parametrize("case", list(_PHASE_CASES))
def test_three_phase_backward_matches_reference_and_pallas(case):
    """Moving G's gate recomputation and dW_hh out of the serial loop keeps
    the function: the three-phase schedule against the reverse loop of
    `_bwd_kernel` written out (gru_backward_reference) and against the
    Pallas kernels in interpret mode (the VJP of pallas_gru.fused_gru).
    Tolerances: f32 1e-5 (absolute on dxp and dh0, relative to max |dW|
    on dW_hh); with bf16 x_proj or w_hh 2e-2, bf16's tolerance: the
    schedules round at the same points, but an f32 difference in the last
    bit can move a bf16 rounding by one step."""
    x_dtype, w_dtype, window, initial = _PHASE_CASES[case]
    npin, targs = _phase_inputs(x_dtype, w_dtype, window, initial)
    three = _three_phase_backward(*targs)
    ref = FG.gru_backward_reference(*targs)
    bf16 = x_dtype == "bfloat16" or w_dtype == "bfloat16"
    tol = 2e-2 if bf16 else 1e-5
    assert three[0].dtype == ref[0].dtype
    for k in (0, 2):
        _close(three[k].float(), ref[k].float(), tol)
    _close_rel(three[1], ref[1], tol)

    xp, w, h0, jb, dhs, dhl = npin
    jx, jw = jnp.dtype(x_dtype), jnp.dtype(w_dtype)
    jin = (to_jax(xp).astype(jx), to_jax(w).astype(jw), to_jax(h0))

    @jax.jit
    def vjp(a, b_, c, cot):
        _, back = jax.vjp(lambda *z: JPG.fused_gru(*z, to_jax(jb)), a, b_, c)
        return back(cot)

    jgr = vjp(*jin, (to_jax(dhs), to_jax(dhl)))
    mine = (three[0].float(), three[1].to(getattr(torch, w_dtype)).float(),
            three[2])
    for j, t in zip(jgr, mine):
        _close_rel(t, _f32(j), tol)


def test_three_phase_operand_n_column_is_dgn_times_r():
    """dhp, the operand of the carry and of dW_hh, differs from dxp in its
    n column: dgn * r, not dgn. The schedule matches the reference to
    1e-5; a dW_hh taken from dxp's n column misses by more than 1e-2 of
    its scale."""
    _, targs = _phase_inputs("float32", "float32", "ragged", True)
    dxp, dw, _, opnd = _three_phase_backward(*targs)
    ref_dw = FG.gru_backward_reference(*targs)[1]
    _close_rel(dw, ref_dw, 1e-5)
    np.testing.assert_array_equal(opnd[..., :2 * H].numpy(),
                                  dxp[..., :2 * H].numpy())
    h0, hs = targs[2], targs[4]
    hprev = torch.cat([h0.float()[None], hs[:-1].float()]).reshape(-1, H)
    from_dxp = hprev.T @ dxp.float().reshape(-1, 3 * H)
    scale = ref_dw.abs().max().item()
    assert (from_dxp - ref_dw).abs().max().item() > 1e-2 * scale


def _forward_loop_schedule(x_proj, w_hh, h0, bounds, geo):
    """F's forward loop (`time_loop.cuh forward_loop_kernel` with
    `GruFwdCell`) written out CTA by CTA for the geometry `geo`: operand
    plane 1 starts as round_w(h0); step t gives CTA (g, k) its br rows of
    plane (t - 1) & 1 times its units' three gate columns of w_hh (held as
    rows, summed over the staged chunks in order), runs the cells and
    writes hs[t] and round_w(h_t) into plane t & 1. Returns hs."""
    steps, b, g3 = x_proj.shape
    h = g3 // 3
    wd, w = w_hh.dtype, w_hh.float()
    planes = torch.empty((2, b, h), dtype=wd)
    planes[1] = h0.float().to(wd)
    carry = h0.float().clone()
    hs = torch.empty((steps, b, h))
    xp = x_proj.float()
    for t in range(steps):
        src = planes[(t + 1) & 1].float()
        for g in range(geo.row_groups):
            rows = slice(g * geo.br, min(b, (g + 1) * geo.br))
            for k in range(geo.unit_groups):
                units = slice(k * geo.hb, (k + 1) * geo.hb)
                sums = []
                for o in range(3):
                    ws = w[:, o * h:(o + 1) * h][:, units].T   # [hb, H]
                    acc = 0.0
                    for c0 in range(0, h, geo.chunk):
                        cs = slice(c0, c0 + geo.chunk)
                        acc = acc + src[rows, cs] @ ws[:, cs].T
                    sums.append(acc)
                x = xp[t, rows]
                r = torch.sigmoid(x[:, :h][:, units] + sums[0])
                z = torch.sigmoid(x[:, h:2 * h][:, units] + sums[1])
                n = torch.tanh(x[:, 2 * h:][:, units] + r * sums[2])
                hc = carry[rows, units]
                new = torch.where(TL.live(bounds[rows], t),
                                  (1.0 - z) * n + z * hc, hc)
                carry[rows, units] = new
                hs[t, rows, units] = new
                planes[t & 1, rows, units] = new.to(wd)
    return hs


@pytest.mark.parametrize("case", list(_PHASE_CASES))
@pytest.mark.parametrize("card", [(132, 232448), (8, 1200)],
                         ids=["h100", "small_card_l2_rows"])
def test_forward_loop_schedule_matches_reference_and_pallas(case, card):
    """F on the forward loop keeps the function: the CTA-by-CTA schedule
    for `geometry`'s grid (on an H100, and on a small card whose shared
    memory does not hold the gate columns, so the loop reads them from
    w_hh^T) against `_fwd_kernel`'s step loop written out
    (gru_forward_reference) and the Pallas forward in interpret mode.
    Tolerances: f32 1e-5; with bf16 x_proj or w_hh 2e-2 (the operand is
    rounded at the same point, an f32 difference in the last bit can move
    a bf16 rounding by one step)."""
    x_dtype, w_dtype, window, initial = _PHASE_CASES[case]
    npin, targs = _phase_inputs(x_dtype, w_dtype, window, initial)
    geo = FG.geometry(B, H, *card)
    assert geo.resident == (card[0] == 132)
    assert geo.ctas > 1
    hs = _forward_loop_schedule(*targs[:4], geo)
    ref = FG.gru_forward_reference(*targs[:4])
    bf16 = x_dtype == "bfloat16" or w_dtype == "bfloat16"
    tol = 2e-2 if bf16 else 1e-5
    _close(hs, ref, tol)
    xp, w, h0, jb = npin[:4]
    jhs, _ = jax.jit(JPG.fused_gru)(
        to_jax(xp).astype(jnp.dtype(x_dtype)),
        to_jax(w).astype(jnp.dtype(w_dtype)), to_jax(h0), to_jax(jb))
    _close(hs, _f32(jhs), tol)
