"""The port's expert parallelism (`parallel.moe.shard_moe_params`,
`make_expert_parallel_ffn`) on a 4-rank gloo group against the JAX
package's shard_map version on its 8-device CPU mesh: both branches
(tokens split over (data, model) with two all-to-alls, and replicated
tokens with local experts and a psum), with and without drops and with
the router jitter injected as JAX drew it per shard."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as JP

from paddle_tpu.parallel import moe as JMoE

import torch_dist
from torch_dist import EP_CASES

AXES = ("data", "model", "seq")
T, D, F, E = 16, 8, 16, 4
JITTER = 0.1


def _jmesh(shape):
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), AXES)


def _jax_noise(shape, data_axis):
    """The [T, E] jitter multipliers JAX's EP body draws from key(3):
    per (data, model) shard from fold_in(key, shard index) in the joint
    branch, laid end to end as the tokens are; one draw of all T tokens
    in the replicated branch."""
    key = jax.random.key(3)
    if data_axis is None:
        return np.asarray(jax.random.uniform(key, (T, E), jnp.float32,
                                             1.0 - JITTER, 1.0 + JITTER))
    n = shape[0] * shape[1]
    return np.concatenate([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, i), (T // n, E), jnp.float32,
        1.0 - JITTER, 1.0 + JITTER)) for i in range(n)])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = jax.device_get(JMoE.init_moe_params(jax.random.key(0), E, D, F))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    params)
    payload = dict(
        params=params,
        x=np.random.RandomState(9).randn(T, D).astype(np.float32),
        noise_joint={s: _jax_noise(s, "data") for s, a in EP_CASES if a},
        noise_repl={s: _jax_noise(s, None) for s, a in EP_CASES if not a})
    out = torch_dist.run_group(4, "moe_ep_cases", payload,
                               tmp_path_factory.mktemp("moe_ep"))
    return payload, out


def _jax_ep(payload, shape, data_axis, cf, jitter):
    mesh = _jmesh(shape)
    params = JMoE.shard_moe_params(
        jax.tree_util.tree_map(jnp.asarray, payload["params"]), mesh)
    spec = JP(("data", "model")) if data_axis else JP()
    x = jax.device_put(payload["x"], NamedSharding(mesh, spec))
    ffn = JMoE.make_expert_parallel_ffn(mesh, data_axis=data_axis, k=2,
                                        capacity_factor=cf, jitter=jitter)

    def loss(p, x):
        o = ffn(p, x, jax.random.key(3))
        return jnp.mean(o.y ** 2) + 0.01 * o.aux_loss, o

    (_, o), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                  has_aux=True))(params, x)
    return mesh, params, o, gp, gx


@pytest.mark.parametrize("shape,data_axis", EP_CASES)
@pytest.mark.parametrize("cf,jitter", [(4.0, 0.0), (1.25, 0.0),
                                       (1.25, JITTER)])
def test_expert_parallel_ffn_matches_jax(setup, shape, data_axis, cf,
                                         jitter):
    payload, out = setup
    mesh, params, o, gp, gx = _jax_ep(payload, shape, data_axis, cf, jitter)
    flat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(g)
            for p, g in jax.tree_util.tree_leaves_with_path(gp)}
    for r in range(int(np.prod(shape))):
        got = out[r][(shape, data_axis)][(cf, jitter)]
        np.testing.assert_allclose(got["y"], np.asarray(o.y), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["aux"], float(o.aux_loss), rtol=1e-5)
        assert got["dropped"] == pytest.approx(float(o.dropped), abs=1e-6)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, flat[name], rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        np.testing.assert_allclose(got["x_grad"], np.asarray(gx), rtol=1e-4,
                                   atol=1e-6)
        if data_axis:
            # forward and backward: two all-to-alls each
            assert got["counts"]["all_to_all"] == 4
        else:
            assert got["counts"]["all_to_all"] == 0
            assert got["counts"]["all_reduce"] > 0


@pytest.mark.parametrize("shape,data_axis", EP_CASES[:2])
def test_shard_moe_params_places_as_jax(setup, shape, data_axis):
    payload, out = setup
    mesh = _jmesh(shape)
    placed = JMoE.shard_moe_params(
        jax.tree_util.tree_map(jnp.asarray, payload["params"]), mesh)
    for r in range(int(np.prod(shape))):
        got = out[r][(shape, data_axis)]["placed"]
        dev = jax.devices()[r]
        for p, a in jax.tree_util.tree_leaves_with_path(placed):
            node = got
            for k in p:
                node = node[k.key]
            want = [s for s in a.addressable_shards if s.device == dev][0]
            np.testing.assert_array_equal(node, np.asarray(want.data))
