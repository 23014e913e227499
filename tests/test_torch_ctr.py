"""The port's CTR model (`models.ctr.CTRModel`: wide & deep over two
row-sharded tables) against the JAX package's (tests/test_nested_ctr.py:68):
the init tree, `apply` and `loss`, and three train steps against JAX's
jitted step for the "alltoall" and "psum" exchanges, at world size 1 in
process and at model-axis sizes 2 and 4 and a 2 x 2 mesh in a 4-rank
gloo group (loss 1e-5, parameters 1e-4), with untouched table rows
exactly unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optim as JO
from paddle_tpu.core import mesh as mesh_lib
from paddle_tpu.models.ctr import CTRModel as JCTR

from paddle_tpu_torch.core import mesh as TM
from paddle_tpu_torch.models.ctr import CTRModel
from paddle_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from paddle_tpu_torch.optim import optimizers as TO

import torch_dist
from torch_dist_slice import CTR_MESHES, no_process_group_left  # noqa: F401

VOCAB, SLOTS, BATCH = 64, 6, 16


def _jmesh(data, model):
    return mesh_lib.build_mesh(mesh_lib.MeshConfig(data=data, model=model),
                               devices=jax.devices()[:data * model])


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, (BATCH, SLOTS)).astype(np.int32)
    ids[:, -2:] = VOCAB  # empty sentinel slots
    labels = (ids[:, :4].min(1) < VOCAB // 3).astype(np.float32)
    return ids, labels


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(tree))


def _jax_run(shape, exchange, steps=3):
    """JAX's model on its mesh of `shape`: (init params, losses, final
    params)."""
    mesh = _jmesh(*shape)
    m = JCTR(vocab=VOCAB, embed_dim=8, mesh=mesh, hidden=(16,),
             exchange=exchange)
    params, mstate = m.init(jax.random.key(0), BATCH, SLOTS)
    init = _np(params)
    opt = JO.adam(1e-2)
    opt_state = opt.init(params["mlp"])
    step = m.make_train_step(opt, mstate)
    ids, labels = _batch()
    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(ids),
                                       jnp.asarray(labels), jnp.float32(0.1),
                                       i, jax.random.key(i))
        losses.append(float(loss))
    return init, losses, _np(params)


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    for shape in CTR_MESHES + [(1, 1)]:
        for ex in ("alltoall", "psum"):
            runs[shape, ex] = _jax_run(shape, ex)
    return runs


@pytest.fixture(scope="module")
def group(jax_runs, tmp_path_factory):
    ids, labels = _batch()
    payload = dict(vocab=VOCAB, ids=ids, labels=labels,
                   params={s[1]: jax_runs[s, "alltoall"][0]
                           for s in CTR_MESHES})
    return torch_dist.run_group(4, "torch_dist_slice:ctr_cases", payload,
                                tmp_path_factory.mktemp("ctr"))


def _check(got_losses, got_params, want, init):
    _, losses, params = want
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    for k in ("deep", "wide"):
        np.testing.assert_allclose(got_params[k], params[k], rtol=1e-4,
                                   atol=1e-5)
    for a, b in zip(jax.tree.leaves(got_params["mlp"]),
                    jax.tree.leaves(params["mlp"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # rows never looked up are bit for bit the initial ones
    ids, _ = _batch()
    touched = np.unique(ids[ids < VOCAB])
    untouched = np.setdiff1d(np.arange(init["deep"].shape[0]), touched)
    np.testing.assert_array_equal(got_params["deep"][untouched],
                                  init["deep"][untouched])
    np.testing.assert_array_equal(got_params["wide"][untouched],
                                  init["wide"][untouched])
    assert not np.allclose(got_params["deep"][touched],
                           init["deep"][touched])


def _model(exchange):
    mesh = TM.build_mesh(TM.MeshConfig(data=1, model=1), "cpu")
    return CTRModel(vocab=VOCAB, embed_dim=8, mesh=mesh, hidden=(16,),
                    exchange=exchange)


def test_init_tree_matches_jax(jax_runs):
    init = jax_runs[(1, 1), "alltoall"][0]
    params, mstate = _model("alltoall").init(0, BATCH, SLOTS)
    got = params_to_numpy(params)
    assert mstate == {}
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(init))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(init)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # the sentinel row exists; the tables' init scale is JAX's
    assert got["deep"].shape == (VOCAB + 1, 8)
    assert 0.005 < got["deep"].std() < 0.02


@pytest.mark.parametrize("exchange", ["alltoall", "psum"])
def test_apply_and_loss_match_jax(jax_runs, exchange):
    init = jax_runs[(1, 1), exchange][0]
    jm = JCTR(vocab=VOCAB, embed_dim=8, mesh=_jmesh(1, 1), hidden=(16,),
              exchange=exchange)
    ids, labels = _batch()
    jparams = jax.tree.map(jnp.asarray, init)
    want = jax.jit(lambda p: jm.apply(p, {}, jnp.asarray(ids)))(jparams)
    want_loss = jax.jit(lambda p: jm.loss(p, {}, jnp.asarray(ids),
                                          jnp.asarray(labels)))(jparams)
    m = _model(exchange)
    params = m.place(params_from_numpy(init, device="cpu"))
    got = m.apply(params, {}, torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    loss = m.loss(params, {}, torch.from_numpy(ids),
                  torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


@pytest.mark.parametrize("exchange", ["alltoall", "psum"])
def test_train_steps_match_jax_in_process(jax_runs, exchange):
    want = jax_runs[(1, 1), exchange]
    m = _model(exchange)
    params = m.place(params_from_numpy(want[0], device="cpu"))
    opt = TO.adam(1e-2)
    opt_state = opt.init(params["mlp"])
    step = m.make_train_step(opt, {})
    ids, labels = _batch()
    losses = []
    for i in range(3):
        params, opt_state, loss = step(params, opt_state,
                                       torch.from_numpy(ids),
                                       torch.from_numpy(labels), 0.1,
                                       torch.tensor(i, dtype=torch.int32))
        losses.append(float(loss))
    _check(losses, params_to_numpy(params), want, want[0])


@pytest.mark.parametrize("shape", CTR_MESHES)
@pytest.mark.parametrize("exchange", ["alltoall", "psum"])
def test_train_steps_match_jax_across_ranks(jax_runs, group, shape,
                                            exchange):
    """Every rank of the mesh ends with JAX's losses and parameters; the
    all-to-all step moves rows by all-to-all only (no all-gather, and no
    all-reduce but the MLP's gradient and the loss)."""
    want = jax_runs[shape, exchange]
    n = shape[0] * shape[1]
    for r in range(n):
        got = group[r][shape][exchange]
        _check(got["losses"], got["params"], want, want[0])
        counts = got["counts"]
        if exchange == "alltoall":
            # 3 steps x (2 lookups + 2 pushes) x 2 exchanges each
            assert counts["all_to_all"] == 3 * 4 * 2
            assert counts["all_gather"] == 0
        else:
            assert counts["all_to_all"] == 0
