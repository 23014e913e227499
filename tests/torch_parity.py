"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*):
one seeded parameter tree handed to both the JAX package and the port.

tests/conftest.py turns on jax_enable_x64, under which the JAX
`init_params` makes float64 LayerNorm vectors; every JAX leaf is cast to
float32 here so both sides compute in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.weights import params_from_numpy


def make_models(seed=0, embed_std=1.0, **cfg_kwargs):
    """(jax_cfg, torch_cfg, jax_params, torch_params) on the same weights.

    The JAX initializer draws the weights; the embedding table is
    rescaled to `embed_std` so a tiny random model's greedy tokens vary
    from step to step (at the initializer's 0.02 they collapse onto one
    token, which makes a weak parity test)."""
    jcfg = JT.TransformerConfig(**cfg_kwargs)
    tcfg = TT.TransformerConfig(**cfg_kwargs)
    jp = JT.init_params(jax.random.key(seed), jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    jp["embed"]["table"] = jp["embed"]["table"] * (embed_std / 0.02)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def np_f32(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def to_jax(x):
    return jnp.asarray(np.asarray(x))


def to_torch(x):
    return torch.from_numpy(np.array(x))
