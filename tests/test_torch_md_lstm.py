"""The port's 2-D MD-LSTM (`ops.rnn.md_lstm`, `nn.recurrent.MDLSTM`)
against the JAX package's on the same seeded grid and weights: the cell,
the scan from each of the four corners (f32 1e-5) with its gradients
(1e-4 relative, leaf by leaf), and the layer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import recurrent as JNR
from paddle_tpu.ops import rnn as JR
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.nn import recurrent as TNR
from paddle_tpu_torch.nn.module import ShapeSpec
from paddle_tpu_torch.ops import rnn as TR
from torch_parity import assert_tree_close, np_f32, to_jax, to_torch

B, H, W, F, HID = 2, 4, 5, 3, 8
CORNERS = [(False, False), (True, False), (False, True), (True, True)]


def _params(seed=0):
    jp = JR.init_md_lstm_params(jax.random.key(seed), F, HID)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def test_md_lstm_cell_matches_jax():
    rs = np.random.RandomState(0)
    z, cu, cl = np_f32(rs, 3, 5 * HID), np_f32(rs, 3, HID), np_f32(rs, 3, HID)
    jh, jc = JR.md_lstm_cell(to_jax(z), to_jax(cu), to_jax(cl))
    th, tc = TR.md_lstm_cell(to_torch(z), to_torch(cu), to_torch(cl))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows,cols", CORNERS,
                         ids=["top_left", "bottom_left", "top_right",
                              "bottom_right"])
def test_md_lstm_every_corner_matches_jax(rows, cols):
    jp, tp = _params(1)
    rs = np.random.RandomState(2)
    x = np_f32(rs, B, H, W, F)
    w = np_f32(rs, B, H, W, HID)
    kw = dict(reverse_rows=rows, reverse_cols=cols)

    def jloss(p, a):
        out = JR.md_lstm(p, a, **kw)
        return jnp.sum(out * to_jax(w)), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, to_jax(x))
    for t in tp.values():
        t.requires_grad_(True)
    tx = to_torch(x).requires_grad_(True)
    tout = TR.md_lstm(tp, tx, **kw)
    assert tout.shape == (B, H, W, HID)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    names = sorted(tp)
    grads = torch.autograd.grad(torch.sum(tout * to_torch(w)),
                                [tp[k] for k in names] + [tx])
    assert_tree_close(dict(zip(names + ["x"], grads)),
                      {**{k: jgp[k] for k in names}, "x": jgx}, 1e-4)


def test_md_lstm_corner_cell_sees_only_its_input():
    """The scan's first cell has zero neighbours: its h is the cell of its
    own projection with zero states (the off-grid slots stay zero)."""
    _, tp = _params(3)
    x = to_torch(np_f32(np.random.RandomState(4), 1, H, W, F))
    out = TR.md_lstm(tp, x, reverse_rows=True, reverse_cols=True)
    z = x[0, -1, -1] @ tp["w_ih"] + tp["b"]
    zero = torch.zeros(HID)
    h, _ = TR.md_lstm_cell(z, zero, zero)
    torch.testing.assert_close(out[0, -1, -1], h, rtol=0, atol=1e-6)


def test_mdlstm_layer_matches_jax():
    layer_j = JNR.MDLSTM(HID, reverse_cols=True)
    layer_t = TNR.MDLSTM(HID, reverse_cols=True)
    x = np_f32(np.random.RandomState(5), B, H, W, F)
    jp, _ = layer_j.init(jax.random.key(6), jnp.zeros((B, H, W, F),
                                                      jnp.float32))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    tp0, _ = layer_t.init(0, ShapeSpec((B, H, W, F)), device="cpu")
    assert {k: tuple(v.shape) for k, v in tp0.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}
    # both forget-gate blocks of the bias start at 1
    assert torch.equal(tp0["b"][2 * HID:4 * HID], torch.ones(2 * HID))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    jout, _ = layer_j.apply(jp, {}, to_jax(x))
    tout, _ = layer_t.apply(tp, {}, to_torch(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    assert layer_t.out_spec(ShapeSpec((B, H, W, F))).shape == (B, H, W, HID)


def test_init_md_lstm_params_defaults_to_the_card(monkeypatch):
    p = TR.init_md_lstm_params(0, F, HID, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_ih": (F, 5 * HID), "w_row": (HID, 5 * HID),
        "w_col": (HID, 5 * HID), "b": (5 * HID,)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.init_md_lstm_params(0, F, HID)
