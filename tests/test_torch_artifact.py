"""Compiled-model artifacts of the port (`paddle_tpu_torch.serve.artifact`,
`serve.capi_bridge`) and kernels A, B and C as registered operators, on
the CPU: the port of tests/test_serve.py's artifact and decoder cases.

- `export_compiled_model` / `load_compiled_model`: a forward with its
  weights folded in, equal to the port's forward and to JAX's apply on
  the same weights; the signature checks; a fresh process loads a
  decoder and a merge-model archive with neither the port's models nor
  JAX imported;
- `export_decoder`: greedy tokens equal to JAX's `generate`; the
  variable-length sampled decoder equal to the port's eager `sample`
  with the noise its seed draws; the int8 archive at most 0.35x the f32
  one, its tokens the int8-weight `generate`'s;
- `capi_bridge`'s load, signature, forward and release from Python;
- the operators: schema, fake and autograd checks (`torch.library.
  opcheck`), one node each in an exported graph, and A's gradient bit
  for bit the pre-operator autograd Function's."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models import transformer as JT
from paddle_tpu.nn.module import ShapeSpec as JSpec
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn.module import Sequential as TSeq
from paddle_tpu_torch.ops import flash_attention as FA
from paddle_tpu_torch.ops import paged_attention as PA
from paddle_tpu_torch.ops import ragged_paged_attention as RPA
from paddle_tpu_torch.serve import artifact as ART
from paddle_tpu_torch.serve import capi_bridge, quant
from torch_parity import make_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEC_CFG = dict(vocab=32, dim=16, n_layers=2, n_heads=2, mlp_ratio=2,
               attn_impl="dense")


def _mlp(batch=4, din=16, dout=3):
    """JAX's test MLP and the port's, on JAX's weights."""
    layers = lambda m: [m.Dense(8, activation="relu"), m.Dense(dout)]
    jmodel = jnn.Sequential(layers(jnn))
    jp, js = jmodel.init(jax.random.key(0), JSpec((batch, din)))
    tmodel = TSeq(layers(TL))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.RandomState(0).rand(batch, din).astype(np.float32)
    want = np.asarray(jmodel.apply(jp, js, jnp.asarray(x),
                                   training=False)[0])

    def forward(t):
        return tmodel.apply(tp, {}, t, training=False)[0]

    return forward, x, want


@pytest.fixture(scope="module")
def mlp_art(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("art") / "mlp.ptc")
    forward, x, want = _mlp()
    ART.export_compiled_model(forward, [x], path, name="mlp")
    return path, forward, x, want


@pytest.fixture(scope="module")
def decoder_art(tmp_path_factory):
    jcfg, tcfg, jp, tp = make_models(seed=0, **DEC_CFG)
    path = str(tmp_path_factory.mktemp("art") / "dec.ptc")
    meta = ART.export_decoder(tp, tcfg, path, batch=2, prompt_len=5,
                              steps=4)
    return path, meta, (jcfg, tcfg, jp, tp)


def test_compiled_model_round_trip_matches_the_forward_and_jax(mlp_art):
    path, forward, x, want = mlp_art
    m = ART.load_compiled_model(path)
    assert m.meta["name"] == "mlp" and m.meta["device"] == "cpu"
    assert m.input_signature == [{"shape": [4, 16], "dtype": "float32"}]
    assert m.output_signature == [{"shape": [4, 3], "dtype": "float32"}]
    got = m.predict(x)
    assert torch.equal(got, forward(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_compiled_model_input_validation(mlp_art):
    m = ART.load_compiled_model(mlp_art[0])
    with pytest.raises(ValueError, match="takes 1 inputs"):
        m.predict(np.zeros((4, 16), np.float32), np.zeros(3))
    with pytest.raises(ValueError, match="input shape"):
        m.predict(np.zeros((2, 16), np.float32))
    with pytest.raises(ValueError, match="exported for cpu"):
        ART.load_compiled_model(mlp_art[0], device="cuda")
    with pytest.raises(NotImplementedError, match="StableHLO"):
        ART.extract_mlir(mlp_art[0], os.devnull)


def test_decoder_greedy_matches_jax_generate(decoder_art):
    path, meta, (jcfg, _, jp, tp) = decoder_art
    m = ART.load_compiled_model(path)
    assert m.meta["kind"] == "decoder" and not m.meta["sampled"]
    assert meta["export_s"] > 0
    prompt = np.random.RandomState(0).randint(1, 32, (2, 5)).astype(np.int64)
    got = m.predict(prompt)
    gen = jax.jit(JT.generate, static_argnums=(1, 3))
    want = np.asarray(gen(jp, jcfg, jnp.asarray(prompt, jnp.int32), 4))
    np.testing.assert_array_equal(got.numpy(), want)


def test_decoder_varlen_sampled_matches_the_eager_sampler(tmp_path):
    """The seed input seeds a host generator that draws the program's
    Gumbel noise as `sample` draws from its rng: the same tokens."""
    _, tcfg, _, tp = make_models(seed=1, **DEC_CFG)
    path = str(tmp_path / "dec.ptc")
    ART.export_decoder(tp, tcfg, path, batch=2, prompt_len=6, steps=3,
                       variable_lengths=True, temperature=0.8, top_k=8)
    m = ART.load_compiled_model(path)
    assert m.meta["sampled"] and m.meta["variable_lengths"]
    assert m.input_signature[-1] == {"shape": [], "dtype": "int64",
                                     "role": "seed"}
    prompt = np.zeros((2, 6), np.int64)
    prompt[0] = np.random.RandomState(1).randint(1, 32, 6)
    prompt[1, :4] = np.random.RandomState(2).randint(1, 32, 4)
    lens = np.asarray([6, 4], np.int64)
    got = m.predict(prompt, lens, np.int64(7))
    gen = torch.Generator().manual_seed(7)
    want = TT.sample(tp, tcfg, torch.from_numpy(prompt), 3, rng=gen,
                     temperature=0.8, top_k=8,
                     prompt_lens=torch.from_numpy(lens))
    assert torch.equal(got, want)
    assert not torch.equal(m.predict(prompt, lens, np.int64(8)), got)
    with pytest.raises(ValueError, match="top_k/top_p require temperature"):
        ART.export_decoder(tp, tcfg, path, batch=1, prompt_len=2, steps=1,
                           top_k=3)


def test_int8_decoder_archive_shrinks_and_matches_int8_generate(tmp_path):
    """Weights dominate this decoder's archive: int8 folds in the s8 tree
    (dequantized each step) at most 0.35x the f32 archive's bytes."""
    _, tcfg, _, tp = make_models(seed=1, vocab=64, dim=256, n_layers=1,
                                 n_heads=4, mlp_ratio=4, attn_impl="dense")
    p32, p8 = str(tmp_path / "d32.ptc"), str(tmp_path / "d8.ptc")
    ART.export_decoder(tp, tcfg, p32, batch=1, prompt_len=4, steps=2)
    ART.export_decoder(tp, tcfg, p8, batch=1, prompt_len=4, steps=2,
                       int8_weights=True)
    ratio = os.path.getsize(p8) / os.path.getsize(p32)
    assert ratio <= 0.35, ratio
    m = ART.load_compiled_model(p8)
    assert m.meta["int8_weights"] is True
    prompt = torch.ones((1, 4), dtype=torch.int64)
    want = TT.generate(quant.quantize_params(tp), tcfg, prompt, 2)
    assert torch.equal(m.predict(prompt), want)


LOADER = """
import sys
import numpy as np
from paddle_tpu_torch.serve.artifact import load_compiled_model
dec = load_compiled_model({dec!r})
out = dec.predict(np.ones((2, 5), np.int64))
assert tuple(out.shape) == (2, 9), out.shape
mlp = load_compiled_model({mlp!r})
y = mlp.predict(np.random.RandomState(0).rand(4, 16).astype(np.float32))
assert tuple(y.shape) == (4, 3) and bool(y.isfinite().all())
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("paddle_tpu_torch.models")
             or m == "paddle_tpu" or m.startswith("paddle_tpu."))
print("LOADED", bad)
"""


def test_artifacts_load_with_no_model_code(decoder_art, mlp_art):
    """A decoder and a merge-model archive run in a fresh process that
    never imports the port's models or JAX."""
    code = LOADER.format(dec=decoder_art[0], mlp=mlp_art[0])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert "LOADED []" in r.stdout, r.stderr[-2000:]


def test_capi_bridge_load_signature_forward_release(mlp_art, monkeypatch):
    path, forward, x, _ = mlp_art
    monkeypatch.setenv("PADDLE_TPU_TORCH_DEVICE", "cpu")
    mid = capi_bridge.load(path)
    sig = json.loads(capi_bridge.signature(mid))
    assert sig["inputs"] == [{"shape": [4, 16], "dtype": "float32"}]
    outs = capi_bridge.forward(mid, [x.tobytes()])
    assert [(d, s) for _, d, s in outs] == [("float32", [4, 3])]
    got = np.frombuffer(outs[0][0], np.float32).reshape(4, 3)
    np.testing.assert_array_equal(got, forward(torch.from_numpy(x)).numpy())
    with pytest.raises(ValueError, match="expected 1 inputs"):
        capi_bridge.forward(mid, [])
    capi_bridge.release(mid)
    with pytest.raises(KeyError):
        capi_bridge.signature(mid)
    monkeypatch.setenv("PADDLE_TPU_TORCH_DEVICE", "cuda")
    with pytest.raises(ValueError, match="exported for cpu"):
        capi_bridge.load(path)


# -- kernels A, B and C as operators ----------------------------------------


def _flash_inputs(seed=0, b=2, t=12, h=2, d=16):
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.randn(b, t, h, d).astype(np.float32))
               for _ in range(3))
    return q, k, v, torch.tensor([t, t - 5], dtype=torch.int32)


def _ragged_inputs(int8):
    rs = np.random.RandomState(3)
    q = torch.from_numpy(rs.randn(2, 3, 4, 8).astype(np.float32))
    ka, va = (torch.from_numpy(rs.randn(5, 4, 2, 8).astype(np.float32))
              for _ in range(2))
    table = torch.tensor([[0, 1, 5], [2, 3, 4]], dtype=torch.int32)
    pos0 = torch.tensor([5, 8], dtype=torch.int32)
    active = torch.tensor([True, False])
    if int8:
        (kd, ks), (vd, vs) = PA.kv_quantize(ka), PA.kv_quantize(va)
        return (q, kd, ks, vd, vs, table, pos0, active, 4, 12)
    return (q, ka, va, table, pos0, active, 4, 12)


@pytest.mark.parametrize("case", ["flash_fwd", "flash_fwd_window",
                                  "ragged_walk", "ragged_walk_int8"])
def test_operators_pass_opcheck(case):
    """Schema, fake (meta) implementation against the real one and
    autograd registration per operator (AOT dispatch for B and C; A's
    takes over 10 s on the CPU, and torch.export's capture of A is
    tested below)."""
    op = case.replace("_window", "")
    utils = ("test_schema", "test_autograd_registration", "test_faketensor")
    if op == "flash_fwd":
        q, k, v, lens = _flash_inputs()
        args = (q.requires_grad_(), k, v, lens, True,
                3 if case.endswith("window") else None, 4)
    else:
        args = _ragged_inputs(op.endswith("int8"))
        utils += ("test_aot_dispatch_dynamic",)
    res = torch.library.opcheck(getattr(torch.ops.paddle_tpu_torch, op),
                                args, test_utils=utils)
    assert set(res.values()) == {"SUCCESS"}, res


def test_operators_are_one_node_of_an_exported_graph():
    """torch.export keeps each operator as one node (its CUDA
    implementation runs inside the program on the card)."""
    q, k, v, lens = _flash_inputs()
    ra, ri = _ragged_inputs(False), _ragged_inputs(True)

    def fn(q, k, v, lens):
        o = FA.flash_attention(q, k, v, causal=True, key_lens=lens)
        w = torch.ops.paddle_tpu_torch.ragged_walk(*ra)
        w8 = torch.ops.paddle_tpu_torch.ragged_walk_int8(*ri)
        return o, w + w8

    ep = ART._export(fn, [q, k, v, lens])
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    for op in ("flash_fwd", "ragged_walk", "ragged_walk_int8"):
        assert targets.count(f"paddle_tpu_torch.{op}.default") == 1, op
    got = ART._load_program(ART._save_program(ep)).module()(q, k, v, lens)
    want = fn(q, k, v, lens)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_kernel_impl_on_cpu_tensors_still_raises():
    """The operators' CPU implementations never turn impl="kernel" on
    CPU tensors into a plain run."""
    q, ka, va, table, pos0, active, page, max_len = _ragged_inputs(False)
    for arenas in ((ka, va), (PA.kv_quantize(ka), PA.kv_quantize(va))):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            RPA.ragged_attention(q, *arenas, table, pos0, active,
                                 page_size=page, max_len=max_len,
                                 impl="kernel")


class _PrePRFlash(torch.autograd.Function):
    """The autograd Function A ran through before it became an operator
    (a copy): forward the plain version on CPU tensors, backward
    flash_backward."""

    @staticmethod
    def forward(ctx, q, k, v, lens, causal, window, block_k):
        o, lse = FA.flash_attention_reference(q, k, v, lens, causal=causal,
                                              window=window)
        ctx.save_for_backward(q, k, v, lens, o, lse)
        ctx.causal, ctx.window, ctx.block_k = causal, window, block_k
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, lens, o, lse = ctx.saved_tensors
        dq, dk, dv = FA.flash_backward(q, k, v, lens, o, lse, g,
                                       causal=ctx.causal,
                                       block_k=ctx.block_k,
                                       window=ctx.window)
        return dq, dk, dv, None, None, None, None


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_flash_operator_gradient_equals_the_pre_operator_function(
        causal, window):
    q, k, v, lens = _flash_inputs(seed=4)
    g = torch.from_numpy(np.random.RandomState(5).randn(
        *q.shape).astype(np.float32))
    grads = []
    for run in ("op", "pre"):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        if run == "op":
            o = FA.flash_attention(qq, kk, vv, causal=causal, key_lens=lens,
                                   window=window, block_k=4)
        else:
            o = _PrePRFlash.apply(qq, kk, vv, lens, causal, window, 4)
        o.backward(g)
        grads.append((o.detach(), qq.grad, kk.grad, vv.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
