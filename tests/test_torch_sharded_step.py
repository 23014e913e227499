"""The port's declared-placement half (`parallel.sharding`,
`parallel.train_step.make_sharded_train_step`, `models.transformer`'s
TP rules and kernel A's DTensor rule, TP `generate`) against the JAX
package on its 8-device CPU mesh: rank r's local shard of every leaf is
JAX device r's addressable shard, and 2-3 sharded steps give JAX's
losses and parameters (tests/test_parallel.py's tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh, PartitionSpec as JP

from paddle_tpu import nn as jnn
from paddle_tpu import optim as joptim
from paddle_tpu import parallel as jpar
from paddle_tpu.models import transformer as JT
from paddle_tpu.nn.module import ShapeSpec
from paddle_tpu.ops import losses as jlosses
from paddle_tpu.parallel import sharding as JS
from paddle_tpu.train.state import TrainState as JTrainState

import torch_dist
from torch_dist import LM_KW, MOE_KW, MESH_SHAPES

AXES = ("data", "model", "seq")


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32)
                                  if np.issubdtype(np.asarray(a).dtype,
                                                   np.floating)
                                  else np.asarray(a), tree)


def _jmesh(shape):
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), AXES)


def _mlp():
    return jnn.Sequential([jnn.Dense(32, name="fc1", activation="relu"),
                           jnn.Dense(32, name="fc2", activation="relu"),
                           jnn.Dense(8, name="logits")])


def _mlp_loss(logits, labels):
    return jnp.mean(jlosses.softmax_cross_entropy(logits, labels))


MLP_RULES_J = [("fc1/kernel", JP(None, "model")),
               ("fc2/kernel", JP("model", None))]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rs = np.random.RandomState(0)
    lm = _f32(jax.device_get(JT.init_params(
        jax.random.key(0), JT.TransformerConfig(**LM_KW))))
    lm["embed"]["table"] = lm["embed"]["table"] * 50.0
    moe_lm = _f32(jax.device_get(JT.init_params(
        jax.random.key(1), JT.TransformerConfig(**MOE_KW))))
    mlp, _ = _mlp().init(jax.random.key(2), ShapeSpec((8, 16)))
    mlp = _f32(jax.device_get(mlp))
    payload = dict(
        lm=lm, moe_lm=moe_lm, mlp=mlp,
        table=rs.standard_normal((8, 4)).astype(np.float32),
        odd=rs.standard_normal((3, 5)).astype(np.float32),
        even=rs.standard_normal((4, 6)).astype(np.float32),
        x=rs.rand(8, 16).astype(np.float32),
        y=rs.randint(0, 8, 8).astype(np.int64),
        tokens=rs.randint(0, 64, (4, 9)).astype(np.int32),
        prompt=rs.randint(0, 64, (4, 6)).astype(np.int32))
    out = torch_dist.run_group(4, "sharded_cases", payload,
                               tmp_path_factory.mktemp("sharded"))
    return payload, out


def _shard_of(arr, r):
    dev = jax.devices()[r]
    return np.asarray([s for s in arr.addressable_shards
                       if s.device == dev][0].data)


def _assert_local_shards(jtree, ttree, r, what):
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = jax.tree_util.tree_leaves_with_path(ttree)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl], what
    for (path, ja), (_, ta) in zip(jl, tl):
        np.testing.assert_array_equal(
            np.asarray(ta), _shard_of(ja, r),
            err_msg=f"{what} {jax.tree_util.keystr(path)} rank {r}")


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_each_rank_holds_jax_device_r_shard(setup, shape):
    payload, out = setup
    jm = _jmesh(shape)
    trees = {
        "tp": (payload["lm"], JT.TP_RULES),
        "tp_moe": (payload["moe_lm"], JT.TP_MOE_RULES),
        "megatron": ({**payload["mlp"], "emb": {"table": payload["table"]}},
                     JS.MEGATRON_RULES),
        "fit": ({"odd": payload["odd"], "even": payload["even"]},
                [(r"odd|even", JP("data", "model"))]),
    }
    placed = {k: jax.device_put(t, JS.make_param_shardings(t, jm, r))
              for k, (t, r) in trees.items()}
    adam = joptim.adam(1e-3).init(payload["mlp"])
    placed["zero"] = jax.device_put(adam, JS.zero_shardings(adam, jm))
    for r in range(int(np.prod(shape))):
        for k, jt in placed.items():
            _assert_local_shards(jt, out[r]["place"][shape][k], r, k)


def test_the_router_stays_replicated_under_tp_moe_rules(setup):
    _, out = setup
    full = setup[0]["moe_lm"]["blocks"][1]["moe"]["router"]["kernel"]
    for r in range(4):
        got = out[r]["place"][(2, 2, 1)]["tp_moe"]["blocks"][1]["moe"]
        np.testing.assert_array_equal(got["router"]["kernel"], full)
        assert got["w1"].shape[0] == 2




def _jax_mlp_run(payload, shape, steps, rules=None, zero=False, accum=1):
    jm = _jmesh(shape)
    opt = joptim.adam(1e-3)
    state = jpar.shard_train_state(
        JTrainState.create(jax.tree_util.tree_map(jnp.asarray,
                                                  payload["mlp"]), {}, opt),
        jm, param_rules=rules, zero=zero)
    step = jpar.make_sharded_train_step(_mlp(), _mlp_loss, opt, jm,
                                        param_rules=rules, zero=zero,
                                        accum_steps=accum)
    x = jax.device_put(payload["x"], jpar.batch_sharding(jm))
    y = jax.device_put(payload["y"].astype(np.int32),
                       jpar.batch_sharding(jm))
    losses = []
    for _ in range(steps):
        state, loss, _ = step(state, jax.random.key(0), (x,), (y,))
        losses.append(float(loss))
    return state, losses


def _close_tree(got, want, rtol=1e-4, atol=1e-5):
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(want),
                              jax.tree_util.tree_leaves_with_path(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                                   atol=atol,
                                   err_msg=jax.tree_util.keystr(p))


def test_data_parallel_steps_match_jax(setup):
    payload, out = setup
    state, losses = _jax_mlp_run(payload, (2, 1, 1), 3)
    for r in range(2):
        np.testing.assert_allclose(out[r]["dp"]["losses"], losses,
                                   rtol=1e-5)
        _close_tree(out[r]["dp"]["params"], jax.device_get(state.params))


def test_dp_x_tp_zero_placement_with_accumulation_matches_jax(setup):
    payload, out = setup
    state, losses = _jax_mlp_run(payload, (2, 2, 1), 2, rules=MLP_RULES_J,
                                 zero=True, accum=2)
    for r in range(4):
        got = out[r]["dptp"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _close_tree(got["params"], jax.device_get(state.params))
        # the state stays on its canonical placements: rank r's shards
        # are device r's, parameters and ZeRO-sliced moments alike
        for k in ("fc1", "fc2"):
            ja = state.params[k]["kernel"]
            np.testing.assert_allclose(got["local"][k]["kernel"],
                                       _shard_of(ja, r), rtol=1e-4,
                                       atol=1e-5)
        jm_ = state.opt_state["m"]["logits"]["kernel"]
        assert got["opt_local"]["m"]["logits"]["kernel"].shape == \
            _shard_of(jm_, r).shape


def _jax_lm_tp_run(payload, steps):
    jm = _jmesh((2, 2, 1))
    cfg = JT.TransformerConfig(**LM_KW, attn_impl="dense")
    params = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, payload["lm"]),
        JS.make_param_shardings(payload["lm"], jm, JT.TP_RULES))
    opt = joptim.adam(1e-3)
    opt_state = opt.init(params)
    toks = jax.device_put(payload["tokens"], JS.batch_sharding(jm))

    @jax.jit
    def step(params, opt_state, i):
        loss, grads = jax.value_and_grad(
            lambda p: JT.loss(p, cfg, toks))(params)
        new_params, new_opt = opt.update(grads, opt_state, params, i)
        return new_params, new_opt, loss

    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(i, jnp.int32))
        losses.append(float(loss))
    return params, losses


def test_lm_tensor_parallel_steps_on_kernel_a_rule_match_jax(setup):
    payload, out = setup
    params, losses = _jax_lm_tp_run(payload, 2)
    for r in range(4):
        got = out[r]["lm_tp"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _close_tree(got["params"], jax.device_get(params))
        qkv = params["blocks"][0]["qkv"]["kernel"]
        np.testing.assert_allclose(got["local"]["blocks"][0]["qkv"]["kernel"],
                                   _shard_of(qkv, r), rtol=1e-4, atol=1e-5)
        # the flash operator ran (its plain version: CPU tensors) in
        # every forward and remat-free backward: 2 layers x 2 steps
        assert got["flash_plain_calls"] == 4


def test_tensor_parallel_generate_matches_jax_and_unsharded(setup):
    payload, out = setup
    jm = _jmesh((2, 2, 1))
    cfg = JT.TransformerConfig(**LM_KW, attn_impl="dense")
    params = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, payload["lm"]),
        JS.make_param_shardings(payload["lm"], jm, JT.TP_RULES))
    prompt = jax.device_put(payload["prompt"], JS.batch_sharding(jm))
    want = np.asarray(jax.jit(lambda p, t: JT.generate(p, cfg, t, steps=4))(
        params, prompt))
    for r in range(4):
        got = out[r]["tp_generate"]
        np.testing.assert_array_equal(got["tokens"], want)
        np.testing.assert_array_equal(got["plain"], want)
        assert got["flash_plain_calls"] == LM_KW["n_layers"]


def test_data_parallel_conv_bn_step_equals_the_single_process_step(setup):
    """Batch-split convolutions and pools run on each rank's rows (the
    convolutions' weight gradients partial sums) and BN's statistics
    reduce over the global batch: two float64 steps equal the
    single-process step's."""
    _, out = setup
    want = out[0]["conv_dp"]["plain"]
    for r in range(2):
        got = out[r]["conv_dp"]
        np.testing.assert_allclose(got["sharded"]["losses"], want["losses"],
                                   rtol=1e-12)
        for key in ("params", "mstate"):
            _close_tree(got["sharded"][key], want[key], rtol=1e-10,
                        atol=1e-12)
