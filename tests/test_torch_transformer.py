"""The port's transformer LM held against the live JAX package on the
same weights: `apply` logits within 1e-4 (float32 products summed in
another order across a few layers, on logits of unit scale) and greedy
`generate` tokens exactly equal."""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.weights import params_from_numpy, \
    params_to_numpy
from torch_parity import make_models, to_jax, to_torch

TOL = 1e-4

CONFIGS = {
    "mha": dict(vocab=96, dim=32, n_layers=2, n_heads=4),
    "gqa_ntk": dict(vocab=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                    rope_scaling="ntk", rope_factor=4.0),
    "linear_rope": dict(vocab=64, dim=32, n_layers=2, n_heads=2,
                        rope_scaling="linear", rope_factor=2.0),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_logits_match_jax(name):
    jcfg, tcfg, jp, tp = make_models(seed=1, **CONFIGS[name])
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 11)).astype(
        np.int32)
    ref = np.asarray(JT.apply(jp, jcfg, to_jax(toks)))
    got = TT.apply(tp, tcfg, to_torch(toks)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["mha", "gqa_ntk"])
def test_greedy_generate_tokens_match_jax(name):
    jcfg, tcfg, jp, tp = make_models(seed=2, **CONFIGS[name])
    prompt = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 7)).astype(
        np.int32)
    ref = np.asarray(JT.generate(jp, jcfg, to_jax(prompt), 10))
    got = TT.generate(tp, tcfg, to_torch(prompt), 10).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(set(ref[:, 7:].ravel().tolist())) > 2   # tokens vary


def test_generate_with_prompt_lens_and_eos_match_jax():
    jcfg, tcfg, jp, tp = make_models(seed=3, **CONFIGS["mha"])
    prompt = np.random.RandomState(2).randint(0, jcfg.vocab, (3, 8)).astype(
        np.int32)
    lens = np.array([8, 5, 3], np.int32)
    ref = np.asarray(JT.generate(jp, jcfg, to_jax(prompt), 9,
                                 prompt_lens=to_jax(lens)))
    got = TT.generate(tp, tcfg, to_torch(prompt), 9,
                      prompt_lens=to_torch(lens)).numpy()
    np.testing.assert_array_equal(got, ref)
    eos = int(ref[0, 10])                      # a token row 0 does emit
    ref = np.asarray(JT.generate(jp, jcfg, to_jax(prompt), 9, eos_id=eos,
                                 pad_id=0))
    got = TT.generate(tp, tcfg, to_torch(prompt), 9, eos_id=eos,
                      pad_id=0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_flash_plain_version_equals_dense_in_the_model():
    import dataclasses

    _, tcfg, _, tp = make_models(seed=4, **CONFIGS["gqa_ntk"])
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, tcfg.vocab, (2, 9)))
    dense = TT.apply(tp, dataclasses.replace(tcfg, attn_impl="dense"), toks)
    flash = TT.apply(tp, dataclasses.replace(tcfg, attn_impl="flash"), toks)
    torch.testing.assert_close(flash, dense, atol=1e-5, rtol=0)


def test_init_params_tree_and_distributions_match_jax():
    cfg_kw = CONFIGS["gqa_ntk"]
    jcfg, tcfg = JT.TransformerConfig(**cfg_kw), TT.TransformerConfig(
        **cfg_kw)
    jp = jax.device_get(JT.init_params(jax.random.key(0), jcfg))
    tp = params_to_numpy(TT.init_params(np.random.RandomState(0), tcfg,
                                        device="cpu"))
    j_leaves = jax.tree_util.tree_leaves_with_path(jp)
    t_leaves = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in j_leaves] == [p for p, _ in t_leaves]
    for (path, a), (_, b) in zip(j_leaves, t_leaves):
        assert a.shape == b.shape, path
    d = cfg_kw["dim"]
    qkv = tp["blocks"][0]["qkv"]["kernel"]
    assert np.abs(qkv).max() <= 1 / np.sqrt(d)
    assert abs(tp["embed"]["table"].std() - 0.02) < 0.002
    # a torch.Generator draws the same distributions
    g = torch.Generator().manual_seed(0)
    tg = TT.init_params(g, tcfg, device="cpu")
    assert tg["lm_head"]["kernel"].abs().max() <= 1 / np.sqrt(d)


def test_weight_bridge_round_trip_keeps_layout():
    jcfg, tcfg, jp, tp = make_models(seed=5, **CONFIGS["gqa_ntk"])
    back = params_to_numpy(tp)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(jax.device_get(jp)),
            jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    qkv_w = (jcfg.n_heads + 2 * jcfg.kv_heads) * jcfg.head_dim
    assert tuple(tp["blocks"][0]["qkv"]["kernel"].shape) == (jcfg.dim, qkv_w)
    bf = params_from_numpy(back, device="cpu", dtype=torch.bfloat16)
    assert bf["lm_head"]["kernel"].dtype == torch.bfloat16


def test_unported_options_raise():
    import dataclasses

    _, tcfg, _, tp = make_models(seed=6, **CONFIGS["mha"])
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    # int8 KV caches are ported: generate runs on them
    out = TT.generate(tp, dataclasses.replace(tcfg, kv_cache_dtype="int8"),
                      prompt, 3)
    assert out.shape == (1, 7)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        TT.generate(tp, dataclasses.replace(tcfg, attn_window=2), prompt, 3)
    with pytest.raises(NotImplementedError, match="MoE"):
        TT.init_params(0, dataclasses.replace(tcfg, moe_experts=2),
                       device="cpu")
