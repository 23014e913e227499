"""The port's sharded matmul primitives (`parallel.blocked_matmul`) on a
4-rank gloo group against the JAX package's on its CPU mesh of the same
ring size (the cases of tests/test_blocked_matmul.py): the output-dim
gather ring and the contracting-dim reduce ring with overlap on and off
at rings of 2 and 4, f32 and bf16 (accumulated in f32), the weight-
streaming `blocked_matmul`, the row-parallel `tp_dense` (and its
untileable-batch fallback), the untileable reduce refused, and the
gradients through the rings against JAX's gradient of the oracle. The
pipeline's `tp_axis` is in tests/test_torch_pipeline.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.parallel import blocked_matmul as BM
from paddle_tpu.parallel import compat

import torch_dist

TOL = dict(rtol=2e-6, atol=2e-6)


def _mesh(p):
    return Mesh(np.array(jax.devices()[:p]), ("x",))


def _xw(rng, m, k, n):
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _cases():
    rng = np.random.default_rng(0)
    cases = {}
    for p in (2, 4):
        for mode in ("gather", "reduce"):
            for overlap in (True, False):
                x, w = _xw(rng, 4 * p, 6 * p, 5 * p)
                cases[f"{mode}{p}_{overlap}"] = dict(
                    p=p, kind=mode, overlap=overlap, x=x, w=w,
                    dtype="float32")
        x, w = _xw(rng, 6, 4 * p, 3 * p)
        cases[f"stream{p}"] = dict(p=p, kind="stream", overlap=True, x=x,
                                   w=w, dtype="float32")
    for mode in ("gather", "reduce"):
        x, w = _xw(rng, 8, 32, 8)
        cases[f"{mode}4_bf16"] = dict(p=4, kind=mode, overlap=True, x=x,
                                      w=w, dtype="bfloat16")
    for overlap in (True, False):
        x, w = _xw(rng, 8, 16, 12)
        cases[f"tp4_{overlap}"] = dict(p=4, kind="tp", overlap=overlap,
                                       x=x, w=w, dtype="float32")
    x, w = _xw(rng, 5, 16, 12)
    cases["tp4_untileable"] = dict(p=4, kind="tp", overlap=True, x=x, w=w,
                                   dtype="float32")
    return cases


def _jax(case):
    x, w = jnp.asarray(case["x"]), jnp.asarray(case["w"])
    if case["dtype"] == "bfloat16":
        x, w = x.astype(jnp.bfloat16), w.astype(jnp.bfloat16)
    mesh = _mesh(case["p"])
    if case["kind"] in ("gather", "reduce"):
        fn = BM.collective_matmul(mesh, axis="x", mode=case["kind"],
                                  overlap=case["overlap"])
    elif case["kind"] == "stream":
        fn = BM.blocked_matmul(mesh, axis="x")
    else:
        fn = compat.shard_map(
            lambda a, b: BM.tp_dense(a, b, axis="x",
                                     overlap=case["overlap"]),
            mesh=mesh, in_specs=(P(None, None), P("x", None)),
            out_specs=P(None, None), check_vma=False)
    got = jax.jit(fn)(x, w)
    return np.asarray(got.astype(jnp.float32)), str(got.dtype), \
        np.asarray(BM.matmul_reference(x, w).astype(jnp.float32))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cases = _cases()
    rng = np.random.default_rng(1)
    gx, gw = _xw(rng, 8, 12, 8)
    payload = dict(cases, grad=dict(x=gx, w=gw))
    out = torch_dist.run_group(4, "torch_dist_slice:blocked_cases", payload,
                               tmp_path_factory.mktemp("bm"))
    return cases, payload, out


def _names(kind):
    return [n for n, c in _cases().items() if c["kind"] in kind]


@pytest.mark.parametrize("name", _names(("gather", "reduce", "stream",
                                         "tp")))
def test_primitive_matches_jax(setup, name):
    cases, _, out = setup
    case = cases[name]
    want, dtype, ref = _jax(case)
    tol = (dict(rtol=2e-2, atol=2e-2) if case["dtype"] == "bfloat16"
           else TOL)
    for r in range(case["p"]):
        got = out[r][case["p"]][name]
        assert got["dtype"] == dtype
        np.testing.assert_allclose(got["out"], want, **tol)
        np.testing.assert_allclose(got["out"], ref, **tol)


def test_reduce_refuses_untileable_rows_and_bad_modes(setup):
    _, _, out = setup
    for p in (2, 4):
        for r in range(p):
            assert "M % p" in out[r][p]["reduce_untileable"]
            assert "unknown mode" in out[r][p]["bad_mode"]
    with pytest.raises(ValueError, match="M % p"):
        jax.jit(BM.collective_matmul(_mesh(2), axis="x", mode="reduce"))(
            jnp.ones((5, 8)), jnp.ones((8, 4)))


@pytest.mark.parametrize("p", [2, 4])
def test_gradients_through_the_rings_match_jax(setup, p):
    _, payload, out = setup
    x, w = jnp.asarray(payload["grad"]["x"]), jnp.asarray(
        payload["grad"]["w"])
    want = jax.jit(jax.grad(lambda a, b: jnp.sum(
        BM.matmul_reference(a, b) ** 2), argnums=(0, 1)))(x, w)
    for r in range(p):
        for mode in ("gather", "reduce"):
            gx, gw = out[r][p]["grads"][mode]
            np.testing.assert_allclose(gx, np.asarray(want[0]), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(gw, np.asarray(want[1]), rtol=1e-5,
                                       atol=1e-5)
