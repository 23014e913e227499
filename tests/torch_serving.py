"""Shared set-up for the serving-stack parity tests
(tests/test_torch_serve_*, test_torch_router*): each case is written once
as a scenario over a `side` -- the JAX package's serving classes or the
port's -- and run on both with the same weights, submissions,
`ManualClock` and `FaultPlan`. The two runs must give equal results
(outcome, tokens, error text, retries; logprobs within 1e-4), counters
and fired faults.

The model is the JAX serving tests' small config (vocab 61, dim 32, 2
layers, dense attention) on `torch_parity.make_models`' shared f32
weights. Engines are built once per (side, geometry) and shared by the
scenarios of a module, as the JAX tests share theirs: an engine is
stateless between runs (init_state resets the pool), and the JAX
engine's compiles dominate the cost."""

import dataclasses
import functools
import types

import numpy as np

from paddle_tpu.models import transformer as JT
from paddle_tpu.serve import engine as j_engine
from paddle_tpu.serve import paged as j_paged
from paddle_tpu.serve import policy as j_policy
from paddle_tpu.serve import router as j_router
from paddle_tpu.serve import server as j_server
from paddle_tpu.serve import shm_arena as j_shm
from paddle_tpu.testing import faults as j_faults
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.serve import engine as t_engine
from paddle_tpu_torch.serve import paged as t_paged
from paddle_tpu_torch.serve import policy as t_policy
from paddle_tpu_torch.serve import router as t_router
from paddle_tpu_torch.serve import server as t_server
from paddle_tpu_torch.serve import shm_arena as t_shm
from paddle_tpu_torch.testing import faults as t_faults
from torch_parity import make_models

CFG = dict(vocab=61, dim=32, n_layers=2, n_heads=4, attn_impl="dense")
#: the engine that served a request: the port's is "torch" where JAX's
#: is "jax"; a native backend is "native" in both
BACKEND = {"jax": "torch", "native": "native", None: None}
LP_TOL = 1e-4


def _side(name, T, engine, paged, policy, router, server, shm, faults):
    return types.SimpleNamespace(
        name=name, T=T, DecodeEngine=engine.DecodeEngine,
        ServingServer=server.ServingServer,
        CircuitBreaker=server.CircuitBreaker,
        QueueFullError=server.QueueFullError,
        MigrationRefusedError=server.MigrationRefusedError,
        ServingRouter=router.ServingRouter,
        RouterQueueFullError=router.QueueFullError,
        RandomRoutingPolicy=policy.RandomRoutingPolicy,
        SchedulerPolicy=policy.SchedulerPolicy,
        chain_keys=paged.chain_keys, ShmArena=shm.ShmArena,
        FaultPlan=faults.FaultPlan, ManualClock=faults.ManualClock,
        garbage_prompts=faults.garbage_prompts)


JAX = _side("jax", JT, j_engine, j_paged, j_policy, j_router, j_server,
            j_shm, j_faults)
TORCH = _side("torch", TT, t_engine, t_paged, t_policy, t_router,
              t_server, t_shm, t_faults)


@functools.lru_cache(maxsize=None)
def models(kv_cache_dtype="compute", attn_window=None):
    """(jax_cfg, torch_cfg, jax_params, torch_params), built once per
    process for each cache dtype / window."""
    jcfg, tcfg, jp, tp = make_models(seed=0, **CFG)
    return (dataclasses.replace(jcfg, kv_cache_dtype=kv_cache_dtype,
                                attn_window=attn_window),
            dataclasses.replace(tcfg, kv_cache_dtype=kv_cache_dtype,
                                attn_window=attn_window), jp, tp)


def make_engine(side, *, kv_cache_dtype="compute", attn_window=None,
                **geometry):
    """A fresh engine of `side` on the shared weights."""
    jcfg, tcfg, jp, tp = models(kv_cache_dtype, attn_window)
    if side is JAX:
        return JAX.DecodeEngine(jp, jcfg, **geometry)
    return TORCH.DecodeEngine(tp, tcfg, device="cpu", **geometry)


def engine_cache():
    """A per-module memo: engine(side, key, **geometry) builds each
    (side, key) engine once."""
    made = {}

    def engine(side, key, **geometry):
        k = (side.name, key)
        if k not in made:
            made[k] = make_engine(side, **geometry)
        return made[k]

    return engine


def warm_engines(side, engines, lens, buckets=None):
    """Serve one prompt of each length through each engine (max_new 2):
    the JAX engine compiles a prefill body per chunk width, which a
    module fixture pays once instead of the first case that needs it."""
    ps = [np.arange(1, n + 1, dtype=np.int32) % 61 for n in lens]
    for eng in engines:
        eng.serve(ps, max_new=2, buckets=buckets)


def prompts_rng(n, lens, seed=0):
    r = np.random.RandomState(seed)
    return [r.randint(0, 61, (l,)).astype(np.int32)
            for l, _ in zip(list(lens) * n, range(n))]


def family_prompts(n, seed, prefix_len=8, tail_len=3, n_families=3,
                   prefix_seed=None):
    """tests/test_router.py's mixed traffic: `n` prompts cycling over
    `n_families` 8-token system prefixes plus a unique tail."""
    pr = np.random.RandomState(seed if prefix_seed is None
                               else prefix_seed)
    r = np.random.RandomState(seed)
    prefixes = [pr.randint(0, 61, (prefix_len,)).astype(np.int32)
                for _ in range(n_families)]
    out = []
    for i in range(n):
        tail = r.randint(0, 61, (tail_len,)).astype(np.int32)
        out.append(np.concatenate([prefixes[i % n_families], tail]))
    return out


def assert_same_results(ref, got, *, router=False):
    """Equal terminal records: outcome, tokens, error, retries, times
    and (router) replica/redistributions; logprobs within LP_TOL."""
    assert sorted(ref) == sorted(got)
    for k in ref:
        a, b = ref[k], got[k]
        assert (a.outcome, a.tokens, a.error, a.retries, a.done_at) == (
            b.outcome, b.tokens, b.error, b.retries, b.done_at), (k, a, b)
        assert len(a.logprobs) == len(b.logprobs), k
        if a.logprobs:
            np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=0,
                                       atol=LP_TOL, err_msg=str(k))
        if router:
            assert (a.replica, a.redistributions) == (
                b.replica, b.redistributions), (k, a, b)
        else:
            assert BACKEND[a.backend] == b.backend, (k, a, b)
            assert a.submitted_at == b.submitted_at, k


def run_both(scenario, *, router=False):
    """Run `scenario(side)` on JAX then the port; it returns a dict with
    `results` and any other comparable values (counters, fired faults,
    flags). Every key must match; `results` by `assert_same_results`.
    Returns the port's dict."""
    ref, got = scenario(JAX), scenario(TORCH)
    assert sorted(ref) == sorted(got)
    for k in ref:
        if k == "results":
            assert_same_results(ref[k], got[k], router=router)
        else:
            assert ref[k] == got[k], (k, ref[k], got[k])
    return got
