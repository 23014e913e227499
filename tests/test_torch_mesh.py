"""The port's mesh, process bootstrap and collectives
(`paddle_tpu_torch.core.mesh`, `parallel.distributed`,
`parallel.collectives`) against the JAX package on its 8-device CPU
mesh: rank r of a 4-rank gloo group (tests/torch_dist.py) sits where
JAX's mesh puts device r, and each in-context collective gives device
r's shard_map result and gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as JP

from paddle_tpu.core import mesh as JM
from paddle_tpu.parallel import collectives as JC
from paddle_tpu.parallel import compat
from paddle_tpu_torch.core import mesh as TM
from paddle_tpu_torch.parallel import distributed as TD

import torch_dist

WORLD = 4
AXES = ("data", "model", "seq")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rs = np.random.RandomState(0)
    payload = {"x": rs.standard_normal((16, 6)).astype(np.float32),
               "cot": rs.standard_normal((WORLD, 256)).astype(np.float32)}
    out = torch_dist.run_group(WORLD, "mesh_cases", payload,
                               tmp_path_factory.mktemp("mesh"))
    return payload, out


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), AXES)


@pytest.mark.parametrize("cfg,n", [((-1, 1, 1), 8), ((-1, 2, 1), 8),
                                   ((2, 2, 2), 8), ((-1, 1, 4), 4),
                                   ((3, 1, 1), 8), ((-1, 3, 1), 8)])
def test_mesh_config_resolves_as_jax(cfg, n):
    def run(mod):
        try:
            return mod.MeshConfig(*cfg).resolve(n)
        except ValueError as e:
            return str(e)
    assert run(TM) == run(JM)


def test_process_bootstrap_helpers(ranks):
    _, out = ranks
    for r, res in enumerate(out):
        assert (res["count"], res["index"], res["primary"]) == (WORLD, r,
                                                                r == 0)
        np.testing.assert_array_equal(res["bcast"]["t"], np.zeros(3))
        assert res["bcast"]["host"] == "from 0"
        assert res["agree_same"] is True
        assert res["agree_diff"] is (r == 0)


def test_initialize_without_a_cluster_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    TD.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert TD.process_count() == 1 and TD.is_primary()
    TD.sync_hosts()
    assert TD.broadcast_from_primary({"a": 1}) == {"a": 1}
    assert TD.replicated_agree(3)
    with pytest.raises(ValueError, match="together"):
        TD.initialize("localhost:1", num_processes=2, device="cpu")


@pytest.mark.parametrize("shape", torch_dist.MESH_SHAPES)
def test_rank_sits_where_jax_puts_its_device(ranks, shape):
    _, out = ranks
    jm = _jax_mesh(shape)
    for r in range(int(np.prod(shape))):
        pos = tuple(int(i) for i in np.argwhere(
            jm.devices == jax.devices()[r])[0])
        assert out[r]["coords"][shape] == pos


def _jax_collectives(shape, axis, data, cots):
    """Per-device outputs and gradients of the JAX package's in-context
    collectives under shard_map, with the cotangents the ranks used."""
    jm = _jax_mesh(shape)
    n = jm.shape[axis]
    ndev = int(np.prod(shape))
    x = jnp.asarray(data[:n * 4])
    every = JP(AXES)

    def body(s):
        return {
            "psum": JC.all_reduce_sum(s, axis),
            "pmean": JC.all_reduce_mean(s, axis),
            "gather": JC.all_gather(s, axis)[None],
            "gather_d1": jax.lax.all_gather(s, axis, axis=1, tiled=True)[None],
            "scatter": JC.reduce_scatter(s, axis)[None],
            "a2a": JC.all_to_all(s, axis, split_axis=0, concat_axis=1)[None],
            "ring": JC.ppermute_ring(s, axis)[None],
            "ring_back": JC.ppermute_ring(s, axis, shift=-1)[None],
            "index": JC.axis_index(axis)[None],
        }

    specs = {k: (JP() if k in ("psum", "pmean") else every)
             for k in ("psum", "pmean", "gather", "gather_d1", "scatter",
                       "a2a", "ring", "ring_back", "index")}
    fn = compat.shard_map(body, mesh=jm, in_specs=(JP(axis),),
                          out_specs=specs)
    outs = jax.jit(fn)(x)
    cot = {}
    for k in specs:
        if k == "index":
            continue
        o = outs[k]
        if k in ("psum", "pmean"):
            cot[k] = cots[0][:o.size].reshape(o.shape)
        else:
            per = int(np.prod(o.shape[1:]))
            cot[k] = np.stack([cots[d][:per].reshape(o.shape[1:])
                               for d in range(ndev)])

    @jax.jit
    def grads_of(x):
        return {k: jax.grad(lambda xx: jnp.sum(fn(xx)[k] * c))(x)
                for k, c in cot.items()}

    grads = {k: np.asarray(v) for k, v in grads_of(x).items()}
    return jm, {k: np.asarray(v) for k, v in outs.items()}, grads


@pytest.mark.parametrize("shape", torch_dist.MESH_SHAPES)
def test_collectives_and_their_gradients_match_shard_map(ranks, shape):
    payload, out = ranks
    ndev = int(np.prod(shape))
    for axis in AXES:
        if dict(zip(AXES, shape))[axis] == 1:
            continue
        jm, jout, jgrad = _jax_collectives(shape, axis, payload["x"],
                                           payload["cot"])
        n = jm.shape[axis]
        for r in range(ndev):
            got = out[r]["coll"][shape][axis]
            assert got["index"] == int(jout["index"][r])
            i = got["index"]
            for k, v in got["out"].items():
                want = jout[k] if k in ("psum", "pmean") else jout[k][r]
                np.testing.assert_allclose(v, np.asarray(want).reshape(
                    v.shape), rtol=1e-6, atol=1e-6, err_msg=f"{axis} {k}")
            for k, g in got["grad"].items():
                # JAX's gradient of the [n*4, 6] input, block i: every
                # device of axis index i feeds that block, so it is the
                # sum of those ranks' gradients (one replicated value's
                # cotangent, for psum and pmean, comes back once)
                want = jgrad[k].reshape(n, 4, 6)[i]
                if k not in ("psum", "pmean"):
                    g = sum(out[q]["coll"][shape][axis]["grad"][k]
                            for q in range(ndev)
                            if out[q]["coll"][shape][axis]["index"] == i)
                np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{axis} grad {k}")


@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 2, 1), (4, 1, 1)])
def test_whole_array_collectives(ranks, shape):
    payload, out = ranks
    for r in range(int(np.prod(shape))):
        got = out[r]["coll"][shape]["whole"]
        axis = got["axis"]
        jm = _jax_mesh(shape)
        n = jm.shape[axis]
        arr = jnp.asarray(payload["x"][:n * 2])
        mean = JC.device_all_reduce_mean(arr, jm, axis)
        bc = JC.device_broadcast_from(arr, jm, axis, source=n - 1)
        dev = jax.devices()[r]
        shard = [s for s in mean.addressable_shards if s.device == dev][0]
        np.testing.assert_allclose(got["mean"], np.asarray(shard.data),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["bcast"], np.asarray(bc), rtol=1e-6)
        np.testing.assert_array_equal(got["repl"], payload["x"][:n * 2])


def test_device_none_means_the_card_and_raises_without_one(monkeypatch):
    from paddle_tpu_torch.graft_entry import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.build_mesh(TM.MeshConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.initialize("localhost:1", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
