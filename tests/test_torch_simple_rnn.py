"""The port's fused tanh-RNN time loop against the JAX package's: the
plain forward and backward of `paddle_tpu_torch.ops.fused_rnn` (what
kernels H and I compute) against `paddle_tpu.ops.pallas_rnn
.fused_simple_rnn`, which runs the Pallas kernels in interpret mode on
the CPU, and `ops.rnn.simple_rnn` for every impl against JAX
`simple_rnn(impl="pallas")` and `impl="xla"`. Kernel I's two-phase
schedule (the serial loop storing the carry's operand, then dW_hh as one
split product) is written out in PyTorch and held against both, and the
launch geometry of H and of I's loop is checked at an H100's limits; H's
forward loop is written out CTA by CTA and held against both as well.

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
    memory) at the RNN benchmark's shape, and the shapes it refuses: H's
    forward loop (`geometry`) and I's serial loop (`backward_geometry`)."""
    sms, smem = 132, 232448
    # H and I at the same shape share one grid: 16 row groups x 8 unit
    # groups, 64 units and 4 rows per CTA, one pair per thread, w_hh's
    # columns (H) and rows (I) resident, the whole operand row in one
    # chunk of 512 columns
    g = FR.geometry(64, 512, sms, smem)
    assert tuple(g[:7]) == (16, 8, 64, 4, 4, 256, 512)
    assert g.resident and g.rep == 1 and g.smem <= smem
    assert FR.backward_geometry(64, 512, sms, smem) == g
    # B=4, H=16: one unit per CTA over 16 CTAs, in the 1 x 8 tile
    assert tuple(FR.geometry(4, 16, sms, smem)[:4]) == (1, 16, 1, 32)
    assert tuple(FR.backward_geometry(4, 16, sms, smem)[:4]) == (1, 8, 2, 4)
    with pytest.raises(ValueError, match="pairs"):
        FR.geometry(2048, 512, sms, smem)
    # H=4096 at B=64: H takes it (the one-launch H refused it: its
    # resident columns did not fit), reading w_hh's columns through L2,
    # and so does I, reading w_hh's rows through L2
    g = FR.geometry(64, 4096, sms, smem)
    assert not g.resident and g.ctas <= sms
    assert not FR.backward_geometry(64, 4096, sms, smem).resident
    # B=64, H=2048: H takes it, and so does I (the one-launch I refused it)
    assert FR.geometry(64, 2048, sms, smem).resident
    g = FR.backward_geometry(64, 2048, sms, smem)
    assert g.ctas <= sms and g.rep == 2


def test_backward_loop_takes_the_shapes_h_takes():
    """Over a sweep of B and H, I's loop takes every shape H takes with at
    most 2048 (row, unit) pairs per CTA, the most I's tiles carry (512
    threads x 4). H's one-gate 1 x 8 tile carries up to 4096, so H also
    takes the shapes below, which I refuses -- among them B=100, H=2560,
    which the one-launch H took too (2000 pairs per CTA there; I's row
    groups round 100 rows up to whole 16-row tiles, past 2048 pairs). A
    training step at such a shape is refused before H runs."""
    sms, smem = 132, 232448
    most = max(bound * rep for _, rep, bound in TL.LOOP_TILES)
    taken, refused = 0, []
    for b in (1, 4, 7, 16, 37, 64, 100, 128, 256, 512, 1024):
        for h in (8, 16, 96, 256, 512, 1024, 1536, 2048, 2560, 3072):
            try:
                g = FR.geometry(b, h, sms, smem)
            except ValueError:
                continue
            taken += 1
            try:
                FR.backward_geometry(b, h, sms, smem)
            except ValueError:
                refused.append((b, h))
                assert g.br * g.hb > most == 2048
    assert taken > 60 and refused == [
        (100, 2560), (100, 3072), (128, 2560), (128, 3072), (256, 1536),
        (256, 2048), (512, 1024), (1024, 512)]


def test_training_step_refuses_a_shape_i_does_not_take_before_h_runs(
        monkeypatch):
    """With gradients wanted, `fused_simple_rnn` checks I's geometry before
    it launches H, so a training step fails at its start and not in its
    backward. The card's limits and the inputs' check are stood in for
    (no card here); B=100, H=2560 is a shape H takes and I's loop does
    not."""
    monkeypatch.setattr(FR, "_limits", lambda device: (132, 232448))
    monkeypatch.setattr(TL, "check_inputs", lambda *a: (T, 100, 2560))

    def no_h(*a):
        raise AssertionError("H launched before I's geometry was checked")

    monkeypatch.setattr(FR, "rnn_forward_kernel", no_h)
    FR.geometry(100, 2560, 132, 232448)
    xp = torch.zeros(T, B, H, requires_grad=True)
    w = torch.zeros(H, H, requires_grad=True)
    bounds = FR.make_bounds(B, T, None, False)
    with pytest.raises(ValueError, match="no grid"):
        FR.fused_simple_rnn(xp, w, torch.zeros(B, H), bounds, impl="kernel")
    # without gradients only H runs, and I's geometry is not asked
    with pytest.raises(AssertionError, match="H launched"):
        FR.fused_simple_rnn(xp.detach(), w.detach(), torch.zeros(B, H),
                            bounds, impl="kernel")


def _two_phase_backward(x_proj, w_hh, h0, bounds, hs, dhs, dh_last):
    """Kernel I's schedule (csrc/fused_rnn.cu) written out in plain
    PyTorch: (1) the serial loop with only the carry's product in it,
    which stores dz into dxp and round_w(dz) as the operand; (2) dW_hh =
    round_w(hprev)^T @ operand over all T*B rows, split over the rows as
    the kernel splits them and summed in order. Returns (dxp, dW, dh0,
    operand)."""
    steps, b, h = x_proj.shape
    wd, w = w_hh.dtype, w_hh.float()
    opnd = torch.empty((steps, b, h), dtype=wd)
    dxp = torch.empty_like(x_proj)
    dh_c = dh_last.float()
    for t in reversed(range(steps)):
        ht = hs[t].float()
        dh = dhs[t].float() + dh_c
        m = TL.live(bounds, t)
        dz = torch.where(m, dh * (1.0 - ht * ht), 0.0)
        dxp[t] = dz.to(dxp.dtype)
        opnd[t] = dz.to(wd)
        dh_c = torch.where(m, opnd[t].float() @ w.T, dh)
    splits, chunk = TL.dw_splits(steps * b, h, 1, 132)
    hprev = TL.operand(torch.cat([h0.float()[None], hs[:-1].float()]), wd)
    rows_h, rows_o = hprev.reshape(-1, h), opnd.reshape(-1, h).float()
    dw = torch.zeros(h, h)
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
    "bf16_w_hh": ("float32", "bfloat16", "reversed", False),
    "bf16_both": ("bfloat16", "bfloat16", "reversed", True),
}


def _phase_inputs(x_dtype, w_dtype, window, initial, seed=12):
    """Seeded inputs of one backward call: numpy arrays, then the port's
    tensors with the plain forward's hs."""
    rs = np.random.RandomState(seed)
    xp, w = np_f32(rs, T, B, H), np_f32(rs, H, H) * 0.3
    h0 = np_f32(rs, B, H) * 0.5 if initial else np.zeros((B, H), np.float32)
    dhs, dhl = np_f32(rs, T, B, H), np_f32(rs, B, H)
    bounds = np.asarray(BOUNDS[window], np.int32)
    xdt, wdt = getattr(torch, x_dtype), getattr(torch, w_dtype)
    t_in = (to_torch(xp).to(xdt), to_torch(w).to(wdt), to_torch(h0),
            to_torch(bounds))
    hs = FR.rnn_forward_reference(*t_in)
    return ((xp, w, h0, bounds, dhs, dhl),
            t_in + (hs, to_torch(dhs), to_torch(dhl)))


@pytest.mark.parametrize("case", list(_PHASE_CASES))
def test_two_phase_backward_matches_reference_and_pallas(case):
    """Moving dW_hh out of I's serial loop keeps the function: the
    two-phase schedule against the reverse loop of `_bwd_kernel` written
    out (rnn_backward_reference) and against the Pallas kernels in
    interpret mode (the VJP of pallas_rnn.fused_simple_rnn), on the same
    seeded inputs. Tolerances: f32 1e-5 (absolute on dxp and dh0,
    relative to max |dW| on dW_hh); with bf16 x_proj or w_hh 2e-2, bf16's
    tolerance: the schedules round at the same points, but an f32
    difference in the last bit can move a bf16 rounding by one step."""
    x_dtype, w_dtype, window, initial = _PHASE_CASES[case]
    npin, targs = _phase_inputs(x_dtype, w_dtype, window, initial)
    two = _two_phase_backward(*targs)
    ref = FR.rnn_backward_reference(*targs)
    bf16 = x_dtype == "bfloat16" or w_dtype == "bfloat16"
    tol = 2e-2 if bf16 else 1e-5
    assert two[0].dtype == ref[0].dtype
    for k in (0, 2):
        _close(two[k].float(), ref[k].float(), tol)
    _close_rel(two[1], ref[1], tol)

    xp, w, h0, jb, dhs, dhl = npin
    jx, jw = jnp.dtype(x_dtype), jnp.dtype(w_dtype)
    jin = (to_jax(xp).astype(jx), to_jax(w).astype(jw), to_jax(h0))

    @jax.jit
    def vjp(a, b_, c, cot):
        _, back = jax.vjp(
            lambda *z: JPR.fused_simple_rnn(*z, to_jax(jb)), a, b_, c)
        return back(cot)

    jgr = vjp(*jin, (to_jax(dhs), to_jax(dhl)))
    mine = (two[0].float(), two[1].to(getattr(torch, w_dtype)).float(),
            two[2])
    for j, t in zip(jgr, mine):
        _close_rel(t, _f32(j), tol)


@pytest.mark.parametrize("case", ["nonzero_h0", "bf16_both", "bf16_x_proj",
                                  "bf16_w_hh"])
def test_operand_is_dxp_only_where_the_dtypes_agree(case):
    """The loop stores the operand round_w(dz) apart from dxp. Where
    x_proj's dtype is w_hh's the two hold dz rounded to that one dtype, bit
    for bit (the kernel still writes both: sharing them saved no time that
    the card could tell from its spread). Where the dtypes differ the two
    differ, and dW_hh must come from the operand: with bf16 x_proj and f32
    w_hh a dW_hh from dxp misses the reference by more than 1e-4 of its
    scale."""
    x_dtype, w_dtype, window, initial = _PHASE_CASES[case]
    _, targs = _phase_inputs(x_dtype, w_dtype, window, initial)
    dxp, dw, _, opnd = _two_phase_backward(*targs)
    if x_dtype == w_dtype:
        assert torch.equal(opnd, dxp)
        return
    assert not torch.equal(opnd.float(), dxp.float())
    if x_dtype == "bfloat16":
        h0, hs = targs[2], targs[4]
        hprev = torch.cat([h0.float()[None], hs[:-1].float()]).reshape(-1, H)
        from_dxp = hprev.T @ dxp.float().reshape(-1, H)
        ref_dw = FR.rnn_backward_reference(*targs)[1]
        _close_rel(dw, ref_dw, 1e-5)
        scale = ref_dw.abs().max().item()
        assert (from_dxp - ref_dw).abs().max().item() > 1e-4 * scale


def _forward_loop_schedule(x_proj, w_hh, h0, bounds, geo):
    """H's forward loop (`time_loop.cuh forward_loop_kernel` with
    `RnnFwdCell`) written out CTA by CTA for the geometry `geo`: operand
    plane 1 starts as round_w(h0); step t gives CTA (g, k) its br rows of
    plane (t - 1) & 1 times its units' column of w_hh (held as rows,
    summed over the staged chunks in order), runs the cells and writes
    hs[t] and round_w(h_t) into plane t & 1. Returns hs."""
    steps, b, h = x_proj.shape
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
                ws = w[:, units].T                           # [hb, H]
                acc = 0.0
                for c0 in range(0, h, geo.chunk):
                    cs = slice(c0, c0 + geo.chunk)
                    acc = acc + src[rows, cs] @ ws[:, cs].T
                hc = carry[rows, units]
                new = torch.where(TL.live(bounds[rows], t),
                                  torch.tanh(xp[t, rows][:, units] + acc),
                                  hc)
                carry[rows, units] = new
                hs[t, rows, units] = new
                planes[t & 1, rows, units] = new.to(wd)
    return hs


@pytest.mark.parametrize("case", list(_PHASE_CASES))
@pytest.mark.parametrize("card", [(132, 232448), (8, 1200)],
                         ids=["h100", "small_card_l2_rows"])
def test_forward_loop_schedule_matches_reference_and_pallas(case, card):
    """H on the forward loop keeps the function: the CTA-by-CTA schedule
    for `geometry`'s grid (on an H100, and on a small card whose shared
    memory does not hold w_hh's columns, so the loop reads them from
    w_hh^T) against `_fwd_kernel`'s step loop written out
    (rnn_forward_reference) and the Pallas forward in interpret mode.
    Operand plane 1 holds round_w(h0) before step 0, where the one-launch
    H rounded each staged value of h0 at use: the bf16-w_hh cases with
    nonzero h0 hold the two to the same result. Tolerances: f32 1e-5;
    with bf16 x_proj or w_hh 2e-2 (the operand is rounded at the same
    point, an f32 difference in the last bit can move a bf16 rounding by
    one step)."""
    x_dtype, w_dtype, window, initial = _PHASE_CASES[case]
    npin, targs = _phase_inputs(x_dtype, w_dtype, window, initial)
    geo = FR.geometry(B, H, *card)
    assert geo.resident == (card[0] == 132)
    assert geo.ctas > 1
    hs = _forward_loop_schedule(*targs[:4], geo)
    ref = FR.rnn_forward_reference(*targs[:4])
    bf16 = x_dtype == "bfloat16" or w_dtype == "bfloat16"
    tol = 2e-2 if bf16 else 1e-5
    _close(hs, ref, tol)
    xp, w, h0, jb = npin[:4]
    jhs, _ = jax.jit(JPR.fused_simple_rnn)(
        to_jax(xp).astype(jnp.dtype(x_dtype)),
        to_jax(w).astype(jnp.dtype(w_dtype)), to_jax(h0), to_jax(jb))
    _close(hs, _f32(jhs), tol)


def test_init_rnn_params_shapes_and_scales():
    p = TR.init_rnn_params(0, F, H)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_ih": (F, H), "w_hh": (H, H), "b": (H,)}
    assert float(p["w_ih"].abs().max()) <= 1.0 / np.sqrt(F)
    assert float(p["w_hh"].abs().max()) <= 1.0 / np.sqrt(H)
    assert float(p["b"].abs().max()) == 0.0
