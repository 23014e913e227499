"""Fleet test/bench support: replica builders a CHILD PROCESS can import
by name (port of `paddle_tpu.testing.fleet`).

A `serve.fleet.ReplicaSpec` carries a `"module:function"` builder string
across the spawn boundary; the child imports it and calls it with the
spec's kwargs and `device=` to construct its `ServingServer`. This
module keeps the builders of the port's own tests:

- `build_tiny_server` -- the chaos-suite replica: the tiny deterministic
  transformer the serving tests use (vocab=61, dim=32, 2 layers), with
  weights drawn from `seed` by the port's initializer, or read from a
  `save_tiny_weights` file (the tests bridge the JAX package's weights
  that way), optionally booted from an engine bundle that
  `save_tiny_artifact` wrote parent-side for the same weights and
  geometry.
- `idle_server` -- a no-engine `ServingServer` duck type that boots in
  milliseconds: the orphan-watchdog and supervisor-lifecycle tests need
  real PROCESSES, not real models.
- `orphan_fleet_main`, `orphan_cluster_main`, `orphan_data_fleet_main`
  -- supervisor-in-a-subprocess mains for the orphan tests: boot a
  fleet (or agents) of idle replicas, report the pids up a pipe, then
  park until SIGKILLed, proving the grandchildren exit on the watchdog
  alone (no drain, no atexit ran).
"""

from __future__ import annotations

import time
import types
from typing import Optional

#: the chaos-suite model geometry -- the JAX package's testing.fleet TINY
TINY = dict(vocab=61, dim=32, n_layers=2, n_heads=4, attn_impl="dense")

_IDLE = "paddle_tpu_torch.testing.fleet:idle_server"


def save_tiny_weights(path: str, params) -> str:
    """Write a TINY parameter tree (tensors, or numpy arrays such as the
    JAX package's `jax.device_get(params)`) to an .npz that
    `build_tiny_server(weights=path)` reads, leaves in flatten order."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.pytree import flatten_with_keys

    leaves = [v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v) for _, v in flatten_with_keys(params)]
    with open(path, "wb") as f:
        np.savez(f, *leaves)
    return path


def tiny_params(*, seed: int = 0, weights: Optional[str] = None,
                device: str = "cuda"):
    """The TINY parameter tree on `device`: drawn from `seed` with the
    port's initializer, or read from a `save_tiny_weights` file."""
    import numpy as np

    from paddle_tpu_torch.core.pytree import flatten_with_keys, unflatten_like
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.models.weights import params_from_numpy

    cfg = T.TransformerConfig(**TINY)
    if weights is None:
        return T.init_params(np.random.RandomState(seed), cfg, device=device)
    template = T.init_params(np.random.RandomState(seed), cfg, device="cpu")
    with np.load(weights) as z:
        leaves = [z[f"arr_{i}"]
                  for i in range(len(flatten_with_keys(template)))]
    return params_from_numpy(unflatten_like(template, leaves),
                             device=device)


def _tiny_engine(*, slots: int = 2, max_len: int = 32, page_size: int = 4,
                 seed: int = 0, weights: Optional[str] = None,
                 device: str = "cuda"):
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.serve.engine import DecodeEngine

    cfg = T.TransformerConfig(**TINY)
    return DecodeEngine(tiny_params(seed=seed, weights=weights,
                                    device=device),
                        cfg, slots=slots, max_len=max_len,
                        page_size=page_size, device=device)


def build_tiny_server(*, slots: int = 2, max_len: int = 32,
                      page_size: int = 4, seed: int = 0,
                      max_queue: int = 64, max_retries: int = 1,
                      buckets=(16,), artifact: Optional[str] = None,
                      weights: Optional[str] = None,
                      device: str = "cuda"):
    """Replica builder for fleet tests: the tiny deterministic
    transformer behind a `ServingServer` on `device`. Pass `artifact`
    (written by `save_tiny_artifact` with the SAME weights, geometry and
    buckets) to boot from the engine bundle; a mismatched bundle keeps
    the eager path (counted in `artifact_fallbacks`), never a failed
    boot."""
    from paddle_tpu_torch.serve.server import ServingServer

    engine = _tiny_engine(slots=slots, max_len=max_len,
                          page_size=page_size, seed=seed, weights=weights,
                          device=device)
    return ServingServer(
        engine, max_queue=max_queue, max_retries=max_retries,
        buckets=tuple(buckets) if buckets else None,
        artifact_path=artifact)


def save_tiny_artifact(path: str, *, buckets=(16,), slots: int = 2,
                       max_len: int = 32, page_size: int = 4,
                       seed: int = 0, weights: Optional[str] = None,
                       device: str = "cuda") -> str:
    """Write the engine bundle `build_tiny_server(artifact=...)` boots
    from. Call it with the geometry, weights, buckets and device the
    replicas use, or their manifest check keeps the eager path."""
    from paddle_tpu_torch.serve.artifact import save_engine_artifact

    engine = _tiny_engine(slots=slots, max_len=max_len,
                          page_size=page_size, seed=seed, weights=weights,
                          device=device)
    save_engine_artifact(engine, path, buckets=buckets)
    return path


class _IdleServer:
    """The minimum surface `ReplicaTransportServer` + the supervisor
    lifecycle touch, with no engine behind it: boots in milliseconds,
    serves nothing. Process-lifecycle tests (orphan watchdog,
    spawn/reap) want many real processes and zero model cost."""

    def __init__(self):
        self.engine = types.SimpleNamespace(
            paged=False, prefix_cache=False, page_size=0)
        self.role = "unified"
        self.max_retries = 0
        self.default_deadline_ms = None
        self.results: dict = {}
        self.queue: list = []
        self.draining = False

    @property
    def queue_space(self) -> int:
        return 0

    def load(self) -> int:
        return 0

    def ping(self) -> None:
        pass

    def step(self) -> bool:
        return False

    def pending_requests(self) -> list:
        return []

    def counters(self) -> dict:
        return {}

    def reconcile(self) -> None:
        pass

    def ready_handoffs(self) -> list:
        return []

    def drain(self, *, grace_s=None,
              reason: str = "drain requested") -> None:
        self.draining = True

    def withdraw_queued(self, req_id: int):
        return None

    def submit(self, prompt, **kwargs):
        raise ValueError("idle test replica accepts no traffic")


def idle_server(*, data_plane: Optional[str] = None,
                device: str = "cpu") -> _IdleServer:
    # `data_plane` arrives when the supervisor owns an arena (the name
    # is injected into every replica's kwargs) and `device` from the
    # spec; an idle replica serves no KV and holds nothing on a device
    del data_plane, device
    return _IdleServer()


def idle_spec():
    """The `ReplicaSpec` of an idle replica: it holds nothing on a
    device, so it boots on the CPU wherever it runs."""
    from paddle_tpu_torch.serve.fleet import ReplicaSpec

    return ReplicaSpec(builder=_IDLE, device="cpu")


def orphan_cluster_main(conn) -> None:
    """Subprocess main for the cluster orphan-CHAIN test: become the
    supervisor of two leaseless `cluster.agent` children, each owning
    one idle replica GRANDCHILD; report every pid up the pipe (agents
    first, then grandchildren), then park until SIGKILLed. The test
    asserts the whole three-deep tree exits on the watchdog chain
    alone: supervisor dies -> the agents' pipes EOF -> agents fence
    their replicas and exit -> the replicas' pipes EOF too."""
    from paddle_tpu_torch.cluster.agent import AgentProcess, AgentSpec

    spec = idle_spec()
    agents = [AgentProcess(AgentSpec(host_id=f"host-{i}",
                                     replica_spec=spec)).start()
              for i in range(2)]
    agent_pids, replica_pids = [], []
    for a in agents:
        info = a.wait_ready()
        agent_pids.append(a.pid)
        replica_pids.extend(info["pids"])
    conn.send(agent_pids + replica_pids)
    while True:
        time.sleep(3600)        # waiting for SIGKILL


def orphan_data_fleet_main(conn) -> None:
    """Subprocess main for the DATA-PLANE orphan test: become a
    supervisor that owns the fleet's shared-memory arena, scatter a
    payload into it (this process is the segments' owner), report
    {arena name, ticket, replica pids} up the pipe, then park until
    SIGKILLed. The test asserts the whole tree dies on the watchdog
    chain (the arena's unlink never ran) and that attaching to the
    orphaned arena BY NAME still reclaims every dead-owner segment."""
    from paddle_tpu_torch.serve.fleet import FleetSupervisor

    sup = FleetSupervisor(idle_spec(), min_replicas=2, max_replicas=2,
                          data_plane_segs=8, data_plane_seg_kb=1)
    sup.start()
    ticket = sup.arena.scatter([b"orphaned kv bytes " * 64])
    conn.send({"arena": sup.arena.name, "ticket": ticket,
               "pids": [p.pid for p in sup.procs.values()
                        if p is not None]})
    while True:
        time.sleep(3600)        # waiting for SIGKILL


def orphan_fleet_main(conn) -> None:
    """Subprocess main for the orphan-leak test: become a supervisor
    of idle replica PROCESSES, report their pids, then park until
    SIGKILLed. The test then asserts the grandchildren exit on the
    parent-death watchdog alone -- this process never drains, never
    reaps, and its atexit hooks never run."""
    from paddle_tpu_torch.serve.fleet import FleetSupervisor

    sup = FleetSupervisor(idle_spec(), min_replicas=2, max_replicas=2)
    sup.start()
    conn.send([p.pid for p in sup.procs.values() if p is not None])
    while True:
        time.sleep(3600)        # waiting for SIGKILL
