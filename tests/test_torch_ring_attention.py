"""The port's ring and Ulysses attention and the LM's context-parallel
loss (`parallel.ring_attention`, `models.transformer
.make_context_parallel_loss`) on a 4-rank gloo group against the JAX
package's shard_map versions on its 8-device CPU mesh and against dense
attention: outputs within 1e-5, gradients within 1e-4, causal and not,
seq-only meshes and a data x seq mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from paddle_tpu.models import transformer as JT
from paddle_tpu.parallel import ring_attention as JRA

import torch_dist
from torch_dist import CP_KW, RING_MESHES

AXES = ("data", "model", "seq")


def _jmesh(shape):
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), AXES)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rs = np.random.RandomState(0)
    qkv = {n: rs.standard_normal((2, 8, 4, 8)).astype(np.float32)
           for n in ("q", "k", "v", "cot")}
    params = _f32(jax.device_get(JT.init_params(
        jax.random.key(0), JT.TransformerConfig(**CP_KW))))
    params["embed"]["table"] = params["embed"]["table"] * 50.0
    payload = dict(qkv, cp_params=params,
                   cp_tokens=rs.randint(0, 64, (4, 17)).astype(np.int32),
                   cp_lens=np.array([17, 11, 6, 17], np.int32))
    out = torch_dist.run_group(4, "ring_cases", payload,
                               tmp_path_factory.mktemp("ring"))
    return payload, out


def _jax_attention(payload, shape, batch_axis, kind, causal):
    fn = JRA.make_sequence_parallel_attention(
        _jmesh(shape), kind=kind, causal=causal, batch_axis=batch_axis)
    q, k, v, cot = (jnp.asarray(payload[n]) for n in ("q", "k", "v", "cot"))
    out, vjp = jax.vjp(jax.jit(fn), q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(cot)]


@pytest.mark.parametrize("shape,batch_axis", RING_MESHES)
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_jax_and_dense(setup, shape,
                                                           batch_axis, kind,
                                                           causal):
    payload, out = setup
    want, wgrads = _jax_attention(payload, shape, batch_axis, kind, causal)
    dense = np.asarray(JRA.dense_attention(
        *(jnp.asarray(payload[n]) for n in ("q", "k", "v")), causal=causal))
    n_seq = shape[2]
    for r in range(int(np.prod(shape))):
        got = out[r][shape][(kind, causal)]
        np.testing.assert_allclose(got["out"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["out"], dense, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["dense"], dense, rtol=1e-5,
                                   atol=1e-5)
        for g, w in zip(got["grads"], wgrads):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        # rank r holds its (batch, seq) block: seq index r % n_seq
        d_idx, s_idx = divmod(r, n_seq)
        rows = slice(None) if batch_axis is None else slice(d_idx, d_idx + 1)
        t = 8 // n_seq
        np.testing.assert_allclose(
            got["local"], want[rows, s_idx * t:(s_idx + 1) * t],
            rtol=1e-5, atol=1e-5)


def _jax_cp(payload, shape, batch_axis, kind, lens):
    cfg = JT.TransformerConfig(**CP_KW, attn_impl="dense")
    fn = JT.make_context_parallel_loss(cfg, _jmesh(shape), kind=kind,
                                       batch_axis=batch_axis)
    params = jax.tree_util.tree_map(jnp.asarray, payload["cp_params"])
    toks = jnp.asarray(payload["cp_tokens"])
    lengths = None if lens is None else jnp.asarray(lens)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: fn(p, toks, lengths)))(params)
    plain = JT.loss(params, cfg, toks, lengths)
    return float(loss), float(plain), grads


@pytest.mark.parametrize("shape,batch_axis", RING_MESHES)
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("with_lens", [False, True])
def test_context_parallel_loss_and_grads_match_jax(setup, shape, batch_axis,
                                                   kind, with_lens):
    payload, out = setup
    loss, plain, grads = _jax_cp(payload, shape, batch_axis, kind,
                                 payload["cp_lens"] if with_lens else None)
    np.testing.assert_allclose(loss, plain, rtol=1e-5)
    flat = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
            jax.tree_util.tree_leaves_with_path(grads)}
    for r in range(int(np.prod(shape))):
        got = out[r][shape][("cp", kind, with_lens)]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert len(got["grads"]) == len(flat)
        for name, g in got["grads"].items():
            key = "".join(f"[{int(p)}]" if p.isdigit() else f"['{p}']"
                          for p in name.split("/"))
            np.testing.assert_allclose(g, flat[key], rtol=1e-4, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("shape,batch_axis", RING_MESHES)
def test_context_parallelism_sends_kv_and_never_gathers_the_sequence(
        setup, shape, batch_axis):
    _, out = setup
    n_seq = shape[2]
    for r in range(int(np.prod(shape))):
        ring = out[r][shape][("cp", "ring", False)]["counts"]
        # per layer, forward and backward: K and V pass n - 1 hops each
        assert ring["ppermute"] == CP_KW["n_layers"] * 2 * 2 * (n_seq - 1)
        assert ring["all_gather"] == 0 and ring["all_to_all"] == 0
        uly = out[r][shape][("cp", "ulysses", False)]["counts"]
        assert uly["all_to_all"] == CP_KW["n_layers"] * 4 * 2
        assert uly["all_gather"] == 0 and uly["ppermute"] == 0


def test_context_parallel_loss_refuses_windows_and_experts(setup):
    _, out = setup
    got = out[0][(1, 1, 2)]
    assert "attn_window is not supported" in got[("refused",
                                                  ("attn_window",))]
    assert "route over the whole batch" in got[("refused",
                                                ("moe_experts",))]
