"""Shared set-up for the process-fleet parity tests (test_torch_transport,
test_torch_http_edge, test_torch_fleet, test_torch_agent): each package's
transport, edge, fleet and agent classes as a `side`, the chaos suite's
tiny model (`testing.fleet.TINY`) on `torch_parity.make_models`' shared
f32 weights, and the process helpers of the JAX suite.

Replica processes of the port are spawned with `device="cpu"` and read
the bridged JAX weights from an .npz (`testing.fleet.save_tiny_weights`),
so their tokens are held against the JAX package's engine on the same
weights. The JAX package's own replica children are never spawned here:
its side of a real-process case is the in-process JAX engine."""

import functools
import os
import time
import types

import jax
import numpy as np

from paddle_tpu.serve import fleet as j_fleet
from paddle_tpu.serve import http_edge as j_edge
from paddle_tpu.serve import router as j_router
from paddle_tpu.serve import server as j_server
from paddle_tpu.serve import transport as j_transport
from paddle_tpu.testing import faults as j_faults
from paddle_tpu.testing import fleet as j_tfleet
from paddle_tpu_torch.serve import fleet as t_fleet
from paddle_tpu_torch.serve import http_edge as t_edge
from paddle_tpu_torch.serve import router as t_router
from paddle_tpu_torch.serve import server as t_server
from paddle_tpu_torch.serve import transport as t_transport
from paddle_tpu_torch.testing import faults as t_faults
from paddle_tpu_torch.testing import fleet as t_tfleet
from torch_serving import JAX as JSERVE
from torch_serving import TORCH as TSERVE
from torch_serving import models

TINY = t_tfleet.TINY
assert TINY == j_tfleet.TINY


def _side(serve, fleet, edge, router, server, transport, faults, tfleet):
    return types.SimpleNamespace(
        name=serve.name, serve=serve, fleet=fleet,
        FleetSupervisor=fleet.FleetSupervisor,
        AutoscalePolicy=fleet.AutoscalePolicy, ReplicaSpec=fleet.ReplicaSpec,
        HttpEdge=edge.HttpEdge, ServingRouter=router.ServingRouter,
        ReplicaDeadError=router.ReplicaDeadError,
        ServingServer=server.ServingServer,
        ReplicaTransportServer=transport.ReplicaTransportServer,
        ReplicaClient=transport.ReplicaClient,
        ProcessReplica=transport.ProcessReplica,
        TransportCallError=transport.TransportCallError,
        TransportConnectError=transport.TransportConnectError,
        FaultPlan=faults.FaultPlan, ManualClock=faults.ManualClock,
        IdleServer=tfleet._IdleServer)


JAX = _side(JSERVE, j_fleet, j_edge, j_router, j_server, j_transport,
            j_faults, j_tfleet)
TORCH = _side(TSERVE, t_fleet, t_edge, t_router, t_server, t_transport,
              t_faults, t_tfleet)
SIDES = (JAX, TORCH)

GEOM = dict(slots=2, max_len=32, page_size=4)


@functools.lru_cache(maxsize=None)
def weights_file(directory):
    """The shared f32 weights (JAX's draw, `make_models`) as the .npz a
    port replica process reads; written once per directory."""
    _, _, jp, _ = models()
    path = os.path.join(directory, "tiny_weights.npz")
    return t_tfleet.save_tiny_weights(path, jax.device_get(jp))


def engine(side, index=0):
    """TINY engine number `index` of `side` on the shared weights, built
    once per process (a JAX engine compiles its bodies per instance; a
    server resets the pool of the engine it is given, so cases reuse
    them -- never two live servers on one engine)."""
    return _engine(side.name, index)


@functools.lru_cache(maxsize=None)
def _engine(name, index):
    jcfg, tcfg, jp, tp = models()
    if name == JAX.name:
        return JSERVE.DecodeEngine(jp, jcfg, **GEOM)
    return TSERVE.DecodeEngine(tp, tcfg, device="cpu", **GEOM)


def jax_tokens(prompt, max_new):
    """The JAX package's greedy tokens for one prompt (its serving
    engine 0, bucket 16, on the shared weights): call it only while no
    server is live on that engine."""
    out = engine(JAX).serve([np.asarray(prompt, np.int32)],
                            max_new=max_new, buckets=(16,))
    return [int(t) for t in out[0]]


def mk_prompts(n, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TINY["vocab"], (4 + i % 5,)).astype(np.int32)
            for i in range(n)]


def proc_gone(pid):
    """True when `pid` is dead (missing or a zombie awaiting reap)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError):
        return True
    return state == "Z"


def await_true(cond, timeout_s=20.0, poll_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll_s)
    return cond()


def tiny_spec(directory, **kwargs):
    """The port's `ReplicaSpec` of a TINY replica process on the CPU over
    the shared weights."""
    return t_fleet.ReplicaSpec(
        builder="paddle_tpu_torch.testing.fleet:build_tiny_server",
        kwargs=dict(weights=weights_file(str(directory)), buckets=(16,),
                    max_retries=1, **kwargs),
        device="cpu")
