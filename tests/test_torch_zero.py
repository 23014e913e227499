"""The port's explicit ZeRO step (`parallel.train_step`:
make_zero_train_step, the flat padded optimizer layout,
TrainState.create_zero, reshard_zero_leaf, opt_state_bytes_per_replica)
on a 4-rank gloo group against the JAX package: bit for bit against its
own zero_update=False oracle arm for sgd, momentum and adam
(tests/test_zero.py:60-88), within JAX's tolerances of JAX's ZeRO step
(test_zero.py:107-112), each rank's moment slice JAX device r's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu import nn as jnn
from paddle_tpu.core.mesh import MeshConfig, batch_sharding, build_mesh
from paddle_tpu.optim import optimizers as JO
from paddle_tpu.parallel import make_zero_train_step
from paddle_tpu.parallel import train_step as JTS
from paddle_tpu.train.state import TrainState as JTrainState

import torch_dist
from torch_dist import ZERO_OPTS


def _model():
    return jnn.Sequential([jnn.Dense(7, name="fc", activation="relu"),
                           jnn.Dense(3, name="out")])


def _loss(out, y):
    return jnp.mean((out - y) ** 2)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    y = np.random.RandomState(1).randn(16, 3).astype(np.float32)
    params, _ = _model().init(jax.random.key(0), jnp.zeros((8, 8),
                                                           jnp.float32))
    params = _f32(jax.device_get(params))
    mesh8 = build_mesh(MeshConfig(data=8))
    opt = JO.adam(1e-2)
    s8 = JTrainState.create_zero(params, {}, opt, mesh8)
    step8 = make_zero_train_step(_model(), _loss, opt, mesh8, donate=False)
    for _ in range(2):
        s8, _, _ = step8(s8, jax.random.key(7),
                         jax.device_put(x, batch_sharding(mesh8)),
                         jax.device_put(y, batch_sharding(mesh8)))
    jax_opt = _f32(jax.device_get(s8.opt_state))
    payload = dict(x=x, y=y, params=params, jax_opt=jax_opt)
    out = torch_dist.run_group(4, "zero_cases", payload,
                               tmp_path_factory.mktemp("zero"))
    return payload, out


def _jax_run(payload, n, opt_name, steps=3):
    fn, args = ZERO_OPTS[opt_name]
    opt = getattr(JO, fn)(*args)
    mesh = build_mesh(MeshConfig(data=n), devices=jax.devices()[:n])
    s = JTrainState.create_zero(payload["params"], {}, opt, mesh)
    step = make_zero_train_step(_model(), _loss, opt, mesh, donate=False)
    x = jax.device_put(payload["x"], batch_sharding(mesh))
    y = jax.device_put(payload["y"], batch_sharding(mesh))
    losses = []
    for _ in range(steps):
        s, l, _ = step(s, jax.random.key(7), x, y)
        losses.append(float(l))
    return mesh, s, losses


def _shard(arr, r):
    dev = jax.devices()[r]
    return np.asarray([s for s in arr.addressable_shards
                       if s.device == dev][0].data)


@pytest.mark.parametrize("shape", [(4, 1, 1), (2, 1, 1)])
@pytest.mark.parametrize("opt", list(ZERO_OPTS))
def test_zero_update_bit_exact_vs_its_oracle_arm(setup, shape, opt):
    _, out = setup
    for r in range(shape[0]):
        got = out[r][shape][opt]
        assert got["lz"] == got["lb"]
        for k in got["pz"]:
            for leaf in got["pz"][k]:
                assert np.array_equal(got["pz"][k][leaf],
                                      got["pb"][k][leaf]), (k, leaf)


@pytest.mark.parametrize("shape", [(4, 1, 1), (2, 1, 1)])
@pytest.mark.parametrize("opt", list(ZERO_OPTS))
def test_zero_matches_jax_zero_step(setup, shape, opt):
    payload, out = setup
    mesh, s, losses = _jax_run(payload, shape[0], opt)
    want = jax.device_get(s.params)
    for r in range(shape[0]):
        got = out[r][shape][opt]
        np.testing.assert_allclose(got["lz"], losses, rtol=1e-5)
        for k in want:
            for leaf in want[k]:
                np.testing.assert_allclose(got["pz"][k][leaf],
                                           want[k][leaf], rtol=1e-5,
                                           atol=1e-6)
        # each rank's flat moment slice is JAX device r's shard
        for ok, ov in jax.tree_util.tree_leaves_with_path(s.opt_state):
            node = got["opt_local"]
            for key in ok:
                node = node[key.key]
            np.testing.assert_allclose(node, _shard(ov, r), rtol=1e-5,
                                       atol=1e-7)


def test_create_zero_places_as_jax(setup):
    payload, out = setup
    mesh = build_mesh(MeshConfig(data=4), devices=jax.devices()[:4])
    s = JTrainState.create_zero(payload["params"], {}, JO.adam(1e-2), mesh)
    for r in range(4):
        got = out[r][(4, 1, 1)]["create_zero"]
        for k in payload["params"]:
            for leaf in payload["params"][k]:
                np.testing.assert_array_equal(got["params"][k][leaf],
                                              payload["params"][k][leaf])
                np.testing.assert_array_equal(
                    got["opt"]["m"][k][leaf],
                    _shard(s.opt_state["m"][k][leaf], r))


def test_opt_state_bytes_per_replica_shrink_about_n_fold(setup):
    _, out = setup
    for shape, n in (((4, 1, 1), 4), ((2, 1, 1), 2)):
        bz, bb = out[0][shape]["bytes"]
        assert bz * (n - 1) < bb <= bz * n, (bz, bb)


@pytest.mark.parametrize("shape", [(4, 1, 1), (2, 1, 1)])
def test_reshard_zero_leaf_takes_a_jax_layout_to_this_mesh(setup, shape):
    payload, out = setup
    n = shape[0]
    mesh = build_mesh(MeshConfig(data=n), devices=jax.devices()[:n])
    sizes = JTS.zero_true_sizes(payload["params"], payload["jax_opt"])
    assert out[0][shape]["sizes"] == sizes
    for k in ("m", "v"):
        for mod in payload["params"]:
            for leaf in payload["params"][mod]:
                want = JTS.reshard_zero_leaf(
                    payload["jax_opt"][k][mod][leaf], sizes[k][mod][leaf],
                    mesh)
                for r in range(n):
                    np.testing.assert_array_equal(
                        out[r][shape]["reshard"][k][mod][leaf],
                        _shard(want, r))


def test_zero_step_is_data_parallel_only(setup):
    _, out = setup
    assert "data-parallel only" in out[0]["dp_only"]
    assert "'model' has size 2" in out[0]["dp_only"]
