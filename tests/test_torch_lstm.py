"""The port's fused LSTM time loop against the JAX package's: the plain
forward and backward of `paddle_tpu_torch.ops.fused_lstm` (what kernels
D and E compute) against `paddle_tpu.ops.rnn.lstm(impl="pallas")`, which
runs the Pallas kernels in interpret mode on the CPU, and the port's
masked scan against the JAX scan.

Tolerances (f32): 1e-5 on outputs and final states, 1e-4 relative to
the largest magnitude on gradients (they sum T*B products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.ops import pallas_lstm as JPL
from paddle_tpu.ops import rnn as JR
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.nn import recurrent as TNR
from paddle_tpu_torch.nn.module import ShapeSpec
from paddle_tpu_torch.ops import fused_lstm as FL
from paddle_tpu_torch.ops import rnn as TR
from paddle_tpu_torch.ops import time_loop as TL
from torch_parity import np_f32, to_jax, to_torch

B, T, F, H = 4, 9, 12, 16
LENS = [9, 4, 1, 7]


def _params(seed=0, f=F, h=H):
    jp = JR.init_lstm_params(jax.random.key(seed), f, h)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _close_rel(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    _close(got, want, rel * max(np.abs(want).max(), 1e-30))


def _run_both(reverse, lengths, initial):
    """Outputs, final states and gradients of one seeded loss through
    JAX's Pallas LSTM and the port's fused LSTM (plain versions)."""
    rs = np.random.RandomState(1)
    jp, tp = _params()
    x = np_f32(rs, B, T, F)
    w_o, w_h, w_c = np_f32(rs, B, T, H), np_f32(rs, B, H), np_f32(rs, B, H)
    h0 = np_f32(rs, B, H) * 0.5 if initial else None
    c0 = np_f32(rs, B, H) * 0.5 if initial else None
    lens = None if lengths is None else np.asarray(lengths, np.int32)

    def jloss(p, x, h0, c0):
        st = None if h0 is None else JR.LSTMState(h0, c0)
        o, fin = JR.lstm(p, x, None if lens is None else to_jax(lens),
                         initial_state=st, reverse=reverse, impl="pallas")
        loss = (jnp.sum(o * w_o) + jnp.sum(fin.h * w_h)
                + jnp.sum(fin.c * w_c))
        return loss, (o, fin.h, fin.c)

    args = (jp, to_jax(x), None if h0 is None else to_jax(h0),
            None if c0 is None else to_jax(c0))
    argnums = (0, 1, 2, 3) if initial else (0, 1)
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=argnums,
                                           has_aux=True)(*args)

    tx = to_torch(x).requires_grad_(True)
    leaves = [tp["w_ih"], tp["w_hh"], tp["b"]]
    for t in leaves:
        t.requires_grad_(True)
    st = None
    wrt = [tx] + leaves
    if initial:
        th0, tc0 = (to_torch(a).requires_grad_(True) for a in (h0, c0))
        st = TR.LSTMState(th0, tc0)
        wrt += [th0, tc0]
    o, fin = TR.lstm(tp, tx, None if lens is None else to_torch(lens),
                     initial_state=st, reverse=reverse)
    loss = (torch.sum(o * to_torch(w_o)) + torch.sum(fin.h * to_torch(w_h))
            + torch.sum(fin.c * to_torch(w_c)))
    tgrads = torch.autograd.grad(loss, wrt)
    jg = [jgrads[1], jgrads[0]["w_ih"], jgrads[0]["w_hh"], jgrads[0]["b"]]
    if initial:
        jg += [jgrads[2], jgrads[3]]
    tout = (o.detach(), fin.h.detach(), fin.c.detach())
    return jout, tout, jg, tgrads


@pytest.mark.parametrize("case", [
    dict(reverse=False, lengths=None, initial=False),
    dict(reverse=False, lengths=LENS, initial=False),
    dict(reverse=True, lengths=None, initial=False),
    dict(reverse=True, lengths=LENS, initial=False),
    dict(reverse=False, lengths=None, initial=True),
    dict(reverse=True, lengths=LENS, initial=True),
], ids=["full", "ragged", "reverse", "reverse_ragged", "initial_state",
        "initial_state_reverse_ragged"])
def test_fused_lstm_matches_jax_pallas(case):
    jout, tout, jg, tg = _run_both(**case)
    for j, t in zip(jout, tout):
        _close(t, j, 1e-5)
    names = ["x", "w_ih", "w_hh", "b", "h0", "c0"]
    for name, j, t in zip(names, jg, tg):
        assert t.shape == tuple(j.shape), name
        _close_rel(t, j)
    if case["lengths"] is not None:
        # positions past each length are zeroed
        assert float(tout[0][1, 4:].abs().sum()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_lstm_op_vjp_matches_jax(dtype):
    """fused_lstm itself: explicit ragged and reversed windows, random
    cotangents for (hs, h_last, c_last). In bf16 both sides round hs and
    the product operands at the same places; the tolerance is bf16's."""
    rs = np.random.RandomState(2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xp = np_f32(rs, T, B, 4 * H)
    w = np_f32(rs, H, 4 * H) * 0.3
    h0, c0 = np_f32(rs, B, H) * 0.5, np_f32(rs, B, H) * 0.5
    bounds = np.array([[0, 9], [0, 4], [5, 9], [2, 7]], np.int32)
    dhs, dhl, dcl = np_f32(rs, T, B, H), np_f32(rs, B, H), np_f32(rs, B, H)
    jin = (to_jax(xp).astype(jdt), to_jax(w).astype(jdt), to_jax(h0),
           to_jax(c0), to_jax(bounds))
    jouts, vjp = jax.vjp(lambda a, b, c, d: JPL.fused_lstm(a, b, c, d,
                                                           jin[4]),
                         *jin[:4])
    jgr = vjp((to_jax(dhs).astype(jdt), to_jax(dhl).astype(jdt),
               to_jax(dcl)))
    tin = [to_torch(xp).to(tdt), to_torch(w).to(tdt), to_torch(h0),
           to_torch(c0)]
    for t in tin:
        t.requires_grad_(True)
    touts = FL.fused_lstm(*tin, to_torch(bounds))
    tgr = torch.autograd.grad(touts, tin, (to_torch(dhs).to(tdt),
                                           to_torch(dhl).to(tdt),
                                           to_torch(dcl)))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for j, t in zip(jouts, touts):
        assert t.dtype == tdt or t.dtype == torch.float32
        _close(t.detach().float(), f32(j), tol)
    for j, t, src in zip(jgr, tgr, tin):
        assert t.dtype == src.dtype
        _close_rel(t.float(), f32(j), 1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("reverse", [False, True])
def test_masked_scan_matches_jax_scan(reverse):
    rs = np.random.RandomState(3)
    jp, tp = _params(seed=1)
    x = np_f32(rs, B, T, F)
    lens = np.asarray(LENS, np.int32)
    jo, jst = JR.lstm(jp, to_jax(x), to_jax(lens), reverse=reverse,
                      impl="xla")
    to, tst = TR.lstm(tp, to_torch(x), to_torch(lens), reverse=reverse,
                      impl="scan")
    _close(to, jo, 1e-5)
    _close(tst.h, jst.h, 1e-5)
    _close(tst.c, jst.c, 1e-5)


def test_bilstm_layer_matches_jax(monkeypatch):
    """nn.BiLSTM on ragged lengths; JAX's layer is forced onto its
    Pallas kernels with its environment override."""
    monkeypatch.setenv("PADDLE_TPU_RNN_IMPL", "pallas")
    rs = np.random.RandomState(4)
    x = np_f32(rs, B, T, F)
    lens = np.asarray(LENS, np.int32)
    jl = jnn.BiLSTM(H)
    jp, js = jl.init(jax.random.key(5), jnn.ShapeSpec(x.shape))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    w_o = np_f32(rs, B, T, 2 * H)

    def jloss(p):
        return jnp.sum(jl.apply(p, js, to_jax(x), to_jax(lens))[0] * w_o)

    jval, jg = jax.value_and_grad(jloss)(jp)
    tl = TNR.BiLSTM(H)
    assert tl.out_spec(ShapeSpec(x.shape)).shape == (B, T, 2 * H)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    leaves = [tp[d][k] for d in ("fwd", "bwd") for k in ("w_ih", "w_hh",
                                                         "b")]
    for t in leaves:
        t.requires_grad_(True)
    out, _ = tl.apply(tp, {}, to_torch(x), to_torch(lens))
    loss = torch.sum(out * to_torch(w_o))
    assert abs(loss.item() - float(jval)) <= 1e-4 * max(1.0, abs(float(jval)))
    for t, (d, k) in zip(torch.autograd.grad(loss, leaves),
                         [(d, k) for d in ("fwd", "bwd")
                          for k in ("w_ih", "w_hh", "b")]):
        _close_rel(t, jg[d][k])


def test_make_bounds_matches_jax():
    lens = np.asarray(LENS, np.int32)
    for reverse in (False, True):
        for ln in (None, lens):
            want = JPL.make_bounds(B, T, None if ln is None else to_jax(ln),
                                   reverse)
            got = FL.make_bounds(B, T, None if ln is None else to_torch(ln),
                                 reverse)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dispatch_on_cpu_runs_plain_versions_and_counts_nothing():
    jp, tp = _params()
    x = torch.randn(B, T, F)
    FL.reset_launch_counts()
    o_none, _ = TR.lstm(tp, x)
    o_torch, _ = TR.lstm(tp, x, impl="torch")
    assert torch.equal(o_none, o_torch)
    assert FL.launch_counts == {"fwd": 0, "bwd": 0}
    with pytest.raises(ValueError, match="CUDA tensors only"):
        TR.lstm(tp, x, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        TR.lstm(tp, x, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        TNR.LSTM(H, impl="xla")


def test_kernel_geometry_and_limits():
    """The launch geometry on an H100 (132 SMs, 227 KB opt-in shared
    memory) at bench_lstm's shapes, and the shapes it refuses: D's and
    E's serial loops (row groups x unit groups; D's forward loop holds
    its units' four gate columns, E's its rows of w_hh)."""
    sms, smem = 132, 232448
    # D: (B, H) -> (row groups, unit groups, hb, br, unit tile, threads,
    # pairs per thread); every grid fits the SMs and its threads cover
    # the CTA's pairs in whole warps
    for (b, h), want in {(64, 256): (16, 8, 32, 4, 4, 128, 1),
                         (128, 256): (16, 8, 32, 8, 4, 256, 1),
                         (64, 512): (4, 32, 16, 16, 4, 256, 1),
                         (128, 512): (4, 32, 16, 32, 2, 256, 2),
                         (64, 1280): (1, 128, 10, 64, 2, 160, 4)}.items():
        g = FL.geometry(b, h, sms, smem)
        assert (g.row_groups, g.unit_groups, g.hb, g.br, g.unit_tile,
                g.threads, g.rep) == want
        assert g.ctas <= sms and g.smem <= smem
        assert g.threads * g.rep >= g.br * g.hb and g.threads % 32 == 0
        assert g.resident
    # D multiplies the whole operand row of 512 columns in one chunk
    assert FL.geometry(64, 512, sms, smem).chunk == 512
    # D keeps its units' gate columns resident at H=1280 (10 units, 201
    # KB), in 32-column chunks beside them
    assert FL.geometry(64, 1280, sms, smem).chunk == 32
    # E: (row groups, unit groups, hb, br, unit tile, threads, chunk) at
    # the main shape, at H=256 B=128, and at H=1280 (one resident slice
    # of 10 units, one row group, 2-unit tiles)
    for (b, h), want in {(64, 512): (4, 32, 16, 16, 4, 256, 512),
                         (128, 256): (16, 8, 32, 8, 4, 256, 512),
                         (64, 1280): (1, 128, 10, 64, 2, 640, 32)}.items():
        g = FL.backward_geometry(b, h, sms, smem)
        assert tuple(g[:7]) == want
        assert g.ctas <= sms and g.smem <= smem
    with pytest.raises(ValueError, match="multiple of 4"):
        FL.geometry(64, 510, sms, smem)
    with pytest.raises(ValueError, match="multiple of 4"):
        FL.backward_geometry(64, 510, sms, smem)
    with pytest.raises(ValueError, match="pairs per CTA"):
        FL.geometry(1024, 1280, sms, smem)
    # the one-launch D staged all B rows in one tile and refused B=1024
    # at H=8; the loop's row groups take it
    assert FL.geometry(1024, 8, sms, smem).row_groups > 1
    with pytest.raises(ValueError, match="132 CTAs"):
        FL.geometry(20000, 512, sms, smem)
    # E at H=4096 (as D takes it): w_hh's rows read from global memory,
    # four pairs per thread; twice the batch is refused
    g = FL.backward_geometry(64, 4096, sms, smem)
    assert not g.resident and g.rep == 4 and g.ctas <= sms
    assert not FL.geometry(64, 4096, sms, smem).resident
    with pytest.raises(ValueError, match="pairs per CTA"):
        FL.backward_geometry(128, 4096, sms, smem)


def test_training_step_refuses_a_shape_e_does_not_take_before_d_runs(
        monkeypatch):
    """With gradients wanted, `fused_lstm` checks E's geometry before it
    launches D, so a training step fails at its start and not in its
    backward. The card's limits and the inputs' check are stood in for
    (no card here); B=20000 at H=512 has no grid of E's loop."""
    monkeypatch.setattr(FL, "device_limits", lambda device: (132, 232448))
    monkeypatch.setattr(FL, "_check", lambda *a: (T, 20000, 512))

    def no_d(*a):
        raise AssertionError("D launched before E's geometry was checked")

    monkeypatch.setattr(FL, "lstm_forward_kernel", no_d)
    xp = torch.zeros(T, B, 4 * H, requires_grad=True)
    w = torch.zeros(H, 4 * H, requires_grad=True)
    z = torch.zeros(B, H)
    bounds = FL.make_bounds(B, T, None, False)
    with pytest.raises(ValueError, match="pairs per CTA"):
        FL.fused_lstm(xp, w, z, z, bounds, impl="kernel")
    # without gradients only D runs, and E's geometry is not asked
    with pytest.raises(AssertionError, match="D launched"):
        FL.fused_lstm(xp.detach(), w.detach(), z, z, bounds, impl="kernel")


def _three_phase_backward(x_proj, w_hh, h0, c0, bounds, hs, cs, dhs,
                          dh_last, dc_last):
    """Kernel E's schedule (csrc/fused_lstm.cu) written out in plain
    PyTorch: (1) the gates of every step at once from round_w(hprev) @
    w_hh; (2) the serial loop with only the carry's product in it, which
    stores the operand round_w(dgates) in w_hh's dtype; (3) dW_hh =
    round_w(hprev)^T @ operand over all T*B rows, split over the rows as
    the kernel splits them and summed in order. Returns (dxp, dW, dh0,
    dc0, operand)."""
    steps, b, g4 = x_proj.shape
    h = g4 // 4
    wd, w = w_hh.dtype, w_hh.float()
    hprev = TL.operand(torch.cat([h0.float()[None], hs[:-1].float()]), wd)
    pre = x_proj.float() + (hprev.reshape(-1, h) @ w).reshape(steps, b, g4)
    i, f, o = (torch.sigmoid(pre[..., k * h:(k + 1) * h]) for k in (0, 1, 3))
    g = torch.tanh(pre[..., 2 * h:3 * h])
    cprev = torch.cat([c0.float()[None], cs[:-1]])
    opnd = torch.empty((steps, b, g4), dtype=wd)
    dxp = torch.empty_like(x_proj)
    dh_c, dc_c = dh_last.float(), dc_last.float()
    for t in reversed(range(steps)):
        tc = torch.tanh(cs[t])
        dh = dhs[t].float() + dh_c
        do = dh * tc * o[t] * (1.0 - o[t])
        dc = dc_c + dh * o[t] * (1.0 - tc * tc)
        di = dc * g[t] * i[t] * (1.0 - i[t])
        df = dc * cprev[t] * f[t] * (1.0 - f[t])
        dg = dc * i[t] * (1.0 - g[t] * g[t])
        m = TL.live(bounds, t)
        dgates = torch.where(m, torch.cat([di, df, dg, do], dim=-1), 0.0)
        dxp[t] = dgates.to(dxp.dtype)
        opnd[t] = dgates.to(wd)
        dh_c = torch.where(m, opnd[t].float() @ w.T, dh)
        dc_c = torch.where(m, dc * f[t], dc_c)
    splits, chunk = TL.dw_splits(steps * b, h, 4, 132)
    rows_h, rows_o = hprev.reshape(-1, h), opnd.reshape(-1, g4).float()
    dw = torch.zeros(h, g4)
    for q in range(splits):
        sl = slice(q * chunk, (q + 1) * chunk)
        dw = dw + rows_h[sl].T @ rows_o[sl]
    return dxp, dw, dh_c, dc_c, opnd


_PHASE_CASES = {
    "full": ("float32", "float32", [[0, 9]] * 4, False),
    "ragged": ("float32", "float32", [[0, 9], [0, 4], [0, 1], [0, 7]], False),
    "reversed": ("float32", "float32", [[0, 9], [5, 9], [8, 9], [2, 9]],
                 False),
    "nonzero_h0_c0": ("float32", "float32", [[0, 9], [0, 4], [5, 9], [2, 7]],
                      True),
    "bf16_x_proj": ("bfloat16", "float32", [[0, 9], [0, 4], [5, 9], [2, 7]],
                    True),
    "bf16_both": ("bfloat16", "bfloat16", [[0, 9], [0, 4], [5, 9], [2, 7]],
                  True),
}


def _phase_inputs(x_dtype, w_dtype, bounds, initial, seed=11):
    """Seeded inputs of one backward call: numpy arrays, then the port's
    tensors with the plain forward's hs and cs."""
    rs = np.random.RandomState(seed)
    xp, w = np_f32(rs, T, B, 4 * H), np_f32(rs, H, 4 * H) * 0.3
    zero = np.zeros((B, H), np.float32)
    h0 = np_f32(rs, B, H) * 0.5 if initial else zero
    c0 = np_f32(rs, B, H) * 0.5 if initial else zero
    dhs, dhl, dcl = np_f32(rs, T, B, H), np_f32(rs, B, H), np_f32(rs, B, H)
    bounds = np.asarray(bounds, np.int32)
    xdt, wdt = getattr(torch, x_dtype), getattr(torch, w_dtype)
    t_in = (to_torch(xp).to(xdt), to_torch(w).to(wdt), to_torch(h0),
            to_torch(c0), to_torch(bounds))
    hs, cs = FL.lstm_forward_reference(*t_in)
    cot = (to_torch(dhs).to(xdt), to_torch(dhl).to(xdt), to_torch(dcl))
    return (xp, w, h0, c0, bounds, dhs, dhl, dcl), t_in + (hs, cs) + cot


@pytest.mark.parametrize("case", list(_PHASE_CASES))
def test_three_phase_backward_matches_reference_and_pallas(case):
    """Moving E's gate recomputation and dW_hh out of the serial loop keeps
    the function: the three-phase schedule against the reverse loop of
    `_bwd_kernel` written out (lstm_backward_reference) and against the
    Pallas kernels in interpret mode (the VJP of pallas_lstm.fused_lstm).
    Tolerances: f32 1e-5 (absolute on dxp, dh0, dc0, relative to max
    |dW| on dW_hh, which sums T*B products); with bf16 x_proj or w_hh 2e-2,
    bf16's tolerance: the schedules round at the same points, but an f32
    difference in the last bit can move a bf16 rounding by one step."""
    x_dtype, w_dtype, bounds, initial = _PHASE_CASES[case]
    npin, targs = _phase_inputs(x_dtype, w_dtype, bounds, initial)
    three = _three_phase_backward(*targs)
    ref = FL.lstm_backward_reference(*targs)
    bf16 = x_dtype == "bfloat16" or w_dtype == "bfloat16"
    tol = 2e-2 if bf16 else 1e-5
    assert three[0].dtype == ref[0].dtype
    for k in (0, 2, 3):
        _close(three[k].float(), ref[k].float(), tol)
    _close_rel(three[1], ref[1], tol)

    xp, w, h0, c0, jb, dhs, dhl, dcl = npin
    jx, jw = jnp.dtype(x_dtype), jnp.dtype(w_dtype)
    jin = (to_jax(xp).astype(jx), to_jax(w).astype(jw), to_jax(h0),
           to_jax(c0))

    @jax.jit
    def vjp(a, b_, c, d, cot):
        _, back = jax.vjp(lambda *z: JPL.fused_lstm(*z, to_jax(jb)),
                          a, b_, c, d)
        return back(cot)

    jgr = vjp(*jin, (to_jax(dhs).astype(jx), to_jax(dhl).astype(jx),
                     to_jax(dcl)))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    mine = (three[0].float(), three[1].to(getattr(torch, w_dtype)).float(),
            three[2], three[3])
    for j, t in zip(jgr, mine):
        _close_rel(t, f32(j), tol)


def test_three_phase_dw_needs_the_rounded_operand():
    """With bf16 x_proj and f32 w_hh, dxp is rounded to bf16 but the
    operand of the carry and of dW_hh is f32: dW_hh must come from the
    operand the loop stores in w_hh's dtype, not from dxp. The schedule
    matches the reference to f32's 1e-5; dW from dxp misses by more than
    1e-4 of its scale."""
    _, targs = _phase_inputs("bfloat16", "float32", _PHASE_CASES[
        "bf16_x_proj"][2], True)
    dxp, dw, _, _, opnd = _three_phase_backward(*targs)
    ref_dw = FL.lstm_backward_reference(*targs)[1]
    assert opnd.dtype == torch.float32 and dxp.dtype == torch.bfloat16
    _close_rel(dw, ref_dw, 1e-5)
    h0, hs = targs[2], targs[5]
    hprev = torch.cat([h0.float()[None], hs[:-1].float()]).reshape(-1, H)
    from_dxp = hprev.T @ dxp.float().reshape(-1, 4 * H)
    scale = ref_dw.abs().max().item()
    assert (from_dxp - ref_dw).abs().max().item() > 1e-4 * scale


def test_lstm_step_matches_jax():
    rs = np.random.RandomState(9)
    jp, tp = _params(seed=2)
    x, h, c = np_f32(rs, B, F), np_f32(rs, B, H), np_f32(rs, B, H)
    jst = JR.lstm_step(jp, to_jax(x), JR.LSTMState(to_jax(h), to_jax(c)))
    tst = TR.lstm_step(tp, to_torch(x), TR.LSTMState(to_torch(h),
                                                     to_torch(c)))
    _close(tst.h, jst.h, 1e-5)
    _close(tst.c, jst.c, 1e-5)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_lstm_under_bf16_policy_matches_jax(param_dtype):
    """Under the bf16 compute policy: the carries stay f32, and x_proj
    (so hs) is f32 with f32 parameters and bf16 with bf16 ones -- the
    dtypes and values of the JAX package's Pallas path (bf16 tolerance)."""
    from paddle_tpu.core import dtypes as JD
    from paddle_tpu_torch.core import dtypes as TD

    rs = np.random.RandomState(10)
    jp, tp = _params(seed=3)
    jp = jax.tree_util.tree_map(lambda a: a.astype(param_dtype), jp)
    tp = {k: v.to(getattr(torch, param_dtype)) for k, v in tp.items()}
    x = np_f32(rs, B, T, F)
    lens = np.asarray(LENS, np.int32)
    jold, told = JD.default_policy(), TD.default_policy()
    JD.set_default_policy(JD.bf16_compute_policy())
    TD.set_default_policy(TD.bf16_compute_policy())
    try:
        assert TR._carry_dtype() == torch.float32
        jo, jst = JR.lstm(jp, to_jax(x), to_jax(lens), impl="pallas")
        to, tst = TR.lstm(tp, to_torch(x), to_torch(lens))
    finally:
        JD.set_default_policy(jold)
        TD.set_default_policy(told)
    for j, t in ((jo, to), (jst.h, tst.h), (jst.c, tst.c)):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        _close(t.float(), np.asarray(j, np.float32), 2e-2)


def _forward_loop_schedule(x_proj, w_hh, h0, c0, bounds, geo):
    """D's forward loop (`time_loop.cuh forward_loop_kernel` with
    `LstmFwdCell`) written out CTA by CTA for the geometry `geo`: operand
    plane 1 starts as round_w(h0); step t gives CTA (g, k) its br rows of
    plane (t - 1) & 1 times its units' four gate columns of w_hh (held as
    rows, summed over the staged chunks in order), runs the cells (c never
    leaves the pair) and writes hs[t], cs[t] and round_w(h_t) into plane
    t & 1. Returns (hs in x_proj's dtype, cs f32)."""
    steps, b, g4 = x_proj.shape
    h = g4 // 4
    wd, w = w_hh.dtype, w_hh.float()
    planes = torch.empty((2, b, h), dtype=wd)
    planes[1] = h0.float().to(wd)
    hc, cc = h0.float().clone(), c0.float().clone()
    hs = torch.empty((steps, b, h), dtype=x_proj.dtype)
    cs = torch.empty((steps, b, h))
    xp = x_proj.float()
    for t in range(steps):
        src = planes[(t + 1) & 1].float()
        for g in range(geo.row_groups):
            rows = slice(g * geo.br, min(b, (g + 1) * geo.br))
            for k in range(geo.unit_groups):
                units = slice(k * geo.hb, (k + 1) * geo.hb)
                sums = []
                for o in range(4):
                    ws = w[:, o * h:(o + 1) * h][:, units].T   # [hb, H]
                    acc = 0.0
                    for k0 in range(0, h, geo.chunk):
                        ks = slice(k0, k0 + geo.chunk)
                        acc = acc + src[rows, ks] @ ws[:, ks].T
                    sums.append(acc)
                x = xp[t, rows]
                gi, gf, go = (torch.sigmoid(x[:, o * h:(o + 1) * h][:, units]
                                            + sums[o]) for o in (0, 1, 3))
                gg = torch.tanh(x[:, 2 * h:3 * h][:, units] + sums[2])
                c_new = gf * cc[rows, units] + gi * gg
                h_new = go * torch.tanh(c_new)
                live = TL.live(bounds[rows], t)
                cc[rows, units] = torch.where(live, c_new, cc[rows, units])
                hc[rows, units] = torch.where(live, h_new, hc[rows, units])
                hs[t, rows, units] = hc[rows, units].to(x_proj.dtype)
                cs[t, rows, units] = cc[rows, units]
                planes[t & 1, rows, units] = hc[rows, units].to(wd)
    return hs, cs


@pytest.mark.parametrize("case", list(_PHASE_CASES))
@pytest.mark.parametrize("card", [(132, 232448), (8, 1200)],
                         ids=["h100", "small_card_l2_rows"])
def test_forward_loop_schedule_matches_reference_and_pallas(case, card):
    """D on the forward loop keeps the function: the CTA-by-CTA schedule
    for `geometry`'s grid (on an H100, and on a small card whose shared
    memory does not hold the gate columns, so the loop reads them from
    w_hh^T) against `_fwd_kernel`'s step loop written out
    (lstm_forward_reference) and the Pallas forward in interpret mode.
    Tolerances: f32 1e-5; with bf16 x_proj or w_hh 2e-2 (the operand is
    rounded at the same point, an f32 difference in the last bit can move
    a bf16 rounding by one step)."""
    x_dtype, w_dtype, window, initial = _PHASE_CASES[case]
    npin, targs = _phase_inputs(x_dtype, w_dtype, window, initial)
    geo = FL.geometry(B, H, *card)
    assert geo.resident == (card[0] == 132)
    assert geo.ctas > 1
    hs, cs = _forward_loop_schedule(*targs[:5], geo)
    ref_hs, ref_cs = FL.lstm_forward_reference(*targs[:5])
    bf16 = x_dtype == "bfloat16" or w_dtype == "bfloat16"
    tol = 2e-2 if bf16 else 1e-5
    assert hs.dtype == ref_hs.dtype
    _close(hs.float(), ref_hs.float(), tol)
    _close(cs, ref_cs, tol)
    xp, w, h0, c0, jb = npin[:5]
    jhs, _, jc = jax.jit(JPL.fused_lstm)(
        to_jax(xp).astype(jnp.dtype(x_dtype)),
        to_jax(w).astype(jnp.dtype(w_dtype)), to_jax(h0), to_jax(c0),
        to_jax(jb))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    _close(hs.float(), f32(jhs), tol)
    _close(cs[-1], f32(jc), tol)
