"""The DecodeEngine pool over tensor-parallel parameters
(`__graft_entry__.py:481 _dryrun_engine_pool`): the port's engine on
TP_RULES DTensor parameters at TP = 2 and 4 (a 4-rank gloo group) serves
the tokens of the single-process pool and of JAX's engine on the same
weights and prompts, float and int8 KV; its arenas split their heads
over the model axis, and every cached read walks each rank's own heads
through kernels B's and C's DTensor rules (the plain walk on the CPU).
The rules on random arenas give the plain walk's output on all heads,
and a placement they do not take is refused."""

import dataclasses

import jax
import numpy as np
import pytest

from paddle_tpu.serve.engine import DecodeEngine as JEngine

from paddle_tpu_torch.core import mesh as TM
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.parallel import sharding as TS
from paddle_tpu_torch.serve.engine import DecodeEngine

import torch_dist
from torch_dist_slice import no_process_group_left  # noqa: F401
from torch_parity import make_models

CFG = dict(vocab=64, dim=32, n_layers=2, n_heads=4, attn_impl="dense")
GEOM = dict(slots=2, max_len=24, page_size=4)


def _prompts():
    return [np.random.RandomState(13 + i).randint(0, 64, (4 + i,))
            .astype(np.int32) for i in range(3)]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jp, tp = make_models(seed=0, **CFG)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def jax_tokens(models):
    jcfg, _, jp, _ = models
    out = {}
    for kv in ("compute", "int8"):
        cfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
        got = JEngine(jp, cfg, **GEOM).serve(_prompts(), max_new=5)
        out[kv] = [list(map(int, t)) for t in got]
    return out


@pytest.fixture(scope="module")
def group(models, tmp_path_factory):
    _, _, jp, _ = models
    payload = dict(cfg=CFG, prompts=[p.tolist() for p in _prompts()],
                   params=jax.device_get(jp))
    return torch_dist.run_group(4, "torch_dist_slice:engine_tp_cases",
                                payload, tmp_path_factory.mktemp("etp"))


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_single_process_pool_matches_jax(models, jax_tokens, kv):
    _, tcfg, _, tp = models
    cfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    got = DecodeEngine(tp, cfg, device="cpu", **GEOM).serve(_prompts(),
                                                           max_new=5)
    assert [list(map(int, t)) for t in got] == jax_tokens[kv]


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_world_size_one_tp_pool_matches_jax(models, jax_tokens, kv):
    """TP_RULES DTensors on a one-rank mesh: every parameter and arena
    replicated, the walks dispatched by the rules' replicated strategy."""
    _, tcfg, _, tp = models
    mesh = TM.build_mesh(TM.MeshConfig(1, 1), "cpu")
    sharded = TS.place(tp, TS.make_param_shardings(tp, mesh, TT.TP_RULES))
    cfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    eng = DecodeEngine(sharded, cfg, device="cpu", **GEOM)
    got = eng.serve(_prompts(), max_new=5)
    assert [list(map(int, t)) for t in got] == jax_tokens[kv]
    arena = eng.init_state().caches[0][0]
    arena = arena[0] if kv == "int8" else arena
    assert hasattr(arena, "placements")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_tp_pool_is_token_equal_to_jax_and_walks_local_heads(
        group, jax_tokens, tp, kv):
    for r in range(tp):
        got = group[r][tp][kv]
        assert got["tokens"] == jax_tokens[kv], (r, tp, kv)
        assert got["placements"] == "(Shard(dim=2),)"
        assert got["local_heads"] == got["geometry_heads"] == 4 // tp
        # every walk of the serve ran on this rank's heads only
        assert got["walk_heads"] == [4 // tp] and got["walks"] > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_walk_rules_match_the_plain_walk_and_refuse_other_placements(
        group, tp):
    for r in range(tp):
        got = group[r][tp]
        assert got["rule_err"]["float"] < 1e-6
        assert got["rule_err"]["int8"] < 1e-6
        assert "the rules take" in got["refused"]


def test_tp_pool_takes_paged_pools_only():
    """A one-rank TP pool's geometry is the config's; a ring
    (sliding-window) pool over DTensor parameters is refused."""
    cfg = TT.TransformerConfig(vocab=64, dim=24, n_layers=1, n_heads=3,
                               attn_impl="dense")
    params = TT.init_params(0, cfg, device="cpu")
    mesh = TM.build_mesh(TM.MeshConfig(1, 1), "cpu")
    sharded = TS.place(params, TS.make_param_shardings(params, mesh,
                                                       TT.TP_RULES))
    eng = DecodeEngine(sharded, cfg, slots=1, max_len=8, device="cpu")
    assert eng.kv_geometry()["kv_heads"] == 3
    ring = dataclasses.replace(cfg, attn_window=4)
    with pytest.raises(ValueError, match="paged pool"):
        DecodeEngine(sharded, ring, slots=1, max_len=8, device="cpu")
