"""The port's GPipe pipeline (`parallel.pipeline`) over a `pipe` mesh
on a 4-rank gloo group against the JAX package's scan+ppermute pipeline
on its 8-device CPU mesh and the sequential stage chain: forward with M
> S, M < S and M = 1, gradients (sharded and full stage params), and a
train step (tests/test_pipeline.py:42-117)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu import optim
from paddle_tpu.parallel import pipeline as PP

import torch_dist


def _jmesh(n):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), (PP.PIPE_AXIS,))


def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _params(s, f, seed):
    r = np.random.RandomState(seed)
    return [{"w": (r.randn(f, f) * 0.5).astype(np.float32),
             "b": (r.randn(f) * 0.1).astype(np.float32)} for _ in range(s)]


def _sequential(per, micro_x):
    out = []
    for x in micro_x:
        for p in per:
            x = _stage_fn(p, x)
        out.append(x)
    return jnp.stack(out)


def _cases():
    cases = {}
    for s in (4, 2):
        cases[f"fwd{s}"] = dict(stages=s, per=_params(s, 6, 0), x=np.random
                                .RandomState(1).randn(5, 3, 6)
                                .astype(np.float32))
        for m in (1, 2):
            cases[f"m{m}_{s}"] = dict(stages=s, per=_params(s, 5, 2),
                                      x=np.random.RandomState(m).randn(
                                          m, 2, 5).astype(np.float32))
        cases[f"grad{s}"] = dict(stages=s, per=_params(s, 4, 3),
                                 x=np.random.RandomState(4).randn(3, 2, 4)
                                 .astype(np.float32),
                                 target=np.ones((3, 2, 4), np.float32))
        cases[f"train{s}"] = dict(
            stages=s, per=_params(s, 4, 5), train=30,
            x=np.random.RandomState(6).randn(4, 2, 4).astype(np.float32),
            target=(np.random.RandomState(7).randn(4, 2, 4) * 0.3)
            .astype(np.float32))
    return cases


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    r = np.random.default_rng(8)
    tp = {"per": [{"w": (r.standard_normal((8, 8)) * 0.3).astype(np.float32),
                   "b": r.standard_normal(8).astype(np.float32)}
                  for _ in range(2)],
          "x": r.standard_normal((5, 4, 8)).astype(np.float32)}
    payload = {"cases": _cases(), "tp": tp}
    out = torch_dist.run_group(4, "pipeline_cases", payload,
                               tmp_path_factory.mktemp("pipe"))
    return payload, out


def _jax_forward(case):
    mesh = _jmesh(case["stages"])
    stacked = PP.shard_stage_params(PP.stack_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p) for p in case["per"]]), mesh)
    return np.asarray(jax.jit(PP.make_pipeline_forward(_stage_fn, mesh))(
        stacked, jnp.asarray(case["x"])))


@pytest.mark.parametrize("name", ["fwd4", "m1_4", "m2_4", "fwd2", "m1_2",
                                  "m2_2"])
def test_pipeline_forward_matches_jax_and_sequential(setup, name):
    payload, out = setup
    case = payload["cases"][name]
    want = _jax_forward(case)
    seq = np.asarray(_sequential(case["per"], jnp.asarray(case["x"])))
    np.testing.assert_allclose(want, seq, rtol=2e-5, atol=2e-5)
    for r in range(case["stages"]):
        got = out[r][case["stages"]][name]["out"]
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s", [4, 2])
def test_pipeline_grads_match_jax_and_sequential(setup, s):
    payload, out = setup
    case = payload["cases"][f"grad{s}"]
    mesh = _jmesh(s)
    stacked = PP.stack_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p) for p in case["per"]])
    fwd = PP.make_pipeline_forward(_stage_fn, mesh)
    x, tgt = jnp.asarray(case["x"]), jnp.asarray(case["target"])
    g_pipe = jax.jit(jax.grad(lambda p: jnp.mean((fwd(p, x) - tgt) ** 2)))(
        PP.shard_stage_params(stacked, mesh))

    def seq_loss(p):
        per = [jax.tree.map(lambda a: a[i], p) for i in range(s)]
        return jnp.mean((_sequential(per, x) - tgt) ** 2)

    g_seq = jax.grad(seq_loss)(stacked)
    for r in range(s):
        got = out[r][s][f"grad{s}"]
        for k in ("w", "b"):
            for g in (got["grads_sharded"][k], got["grads_plain"][k]):
                np.testing.assert_allclose(g, np.asarray(g_pipe[k]),
                                           rtol=3e-4, atol=3e-5)
                np.testing.assert_allclose(g, np.asarray(g_seq[k]),
                                           rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("s", [4, 2])
def test_pipeline_train_step_matches_jax(setup, s):
    payload, out = setup
    case = payload["cases"][f"train{s}"]
    mesh = _jmesh(s)
    stacked = PP.shard_stage_params(PP.stack_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p) for p in case["per"]]), mesh)
    opt = optim.adam(3e-2)
    opt_state = opt.init(stacked)
    step = PP.make_pipeline_train_step(
        _stage_fn, lambda o, y: jnp.mean((o - y) ** 2), opt, mesh)
    losses = []
    params = stacked
    for i in range(case["train"]):
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(case["x"]),
                                       jnp.asarray(case["target"]),
                                       jnp.asarray(i, jnp.int32))
        losses.append(float(loss))
    for r in range(s):
        got = out[r][s][f"train{s}"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4,
                                   atol=1e-6)
        assert got["losses"][-1] < got["losses"][0] * 0.3
        assert got["placements"] == "(Shard(dim=0),)"
        for k in ("w", "b"):
            np.testing.assert_allclose(got["params"][k],
                                       np.asarray(params[k]), rtol=1e-4,
                                       atol=1e-5)


def test_pipeline_tp_axis_is_not_ported_yet(setup):
    """`tp_axis` (tests/test_blocked_matmul.py TestPipelineTensorParallel)
    on a (pipe 2, tp 2) mesh against JAX's pipeline with `tp_axis` on its
    mesh of the same shape and against the plain pipeline: both tp arms'
    outputs, and the gradients through the reduce ring."""
    from jax.sharding import Mesh

    payload, out = setup
    case = payload["tp"]
    stacked = PP.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in case["per"]])
    x = jnp.asarray(case["x"])
    relu = lambda p, a: jax.nn.relu(a @ p["w"] + p["b"])
    relu_tp = lambda p, a, mm: jax.nn.relu(mm(a, p["w"]) + p["b"])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pipe", "tp"))
    pipe = _jmesh(2)
    plain = PP.make_pipeline_forward(relu, pipe)
    ref = jax.jit(plain)(PP.shard_stage_params(stacked, pipe), x)
    g_ref = jax.jit(jax.grad(lambda p: jnp.sum(plain(p, x) ** 2)))(
        PP.shard_stage_params(stacked, pipe))
    sharded = PP.shard_stage_params(stacked, mesh, tp_axis="tp")
    fwds = {arm: PP.make_pipeline_forward(relu_tp, mesh, tp_axis="tp",
                                          tp_overlap=overlap)
            for arm, overlap in (("overlap", True), ("naive", False))}
    runs = {  # explicit literal: one jit wrapper per arm (GL004)
        "overlap": (jax.jit(fwds["overlap"]), jax.jit(jax.grad(
            lambda p: jnp.sum(fwds["overlap"](p, x) ** 2)))),
        "naive": (jax.jit(fwds["naive"]), jax.jit(jax.grad(
            lambda p: jnp.sum(fwds["naive"](p, x) ** 2)))),
    }
    for arm, (fwd, grad) in runs.items():
        want, g_jax = fwd(sharded, x), grad(sharded)
        for r in range(4):
            got = out[r]["tp"]
            assert got["placements"] == "(Shard(dim=0), Shard(dim=1))"
            assert got["local_w"] == (1, 4, 8)
            np.testing.assert_allclose(got[arm], np.asarray(want),
                                       rtol=2e-6, atol=2e-6)
            np.testing.assert_allclose(got[arm], np.asarray(ref),
                                       rtol=2e-6, atol=2e-6)
            for k in ("w", "b"):
                np.testing.assert_allclose(got[f"{arm}_grads"][k],
                                           np.asarray(g_jax[k]), rtol=1e-5,
                                           atol=1e-5)
                np.testing.assert_allclose(got[f"{arm}_grads"][k],
                                           np.asarray(g_ref[k]), rtol=1e-5,
                                           atol=1e-5)
