"""Multi-host control plane (port of `paddle_tpu.cluster`).

- ``cluster.lease`` -- the lease table (TTL + renew + expiry, injectable
  clock), copied unchanged from the JAX package (it imports neither jax
  nor numpy); the gang supervisor's heartbeat staleness runs on it.
- ``cluster.membership`` -- the replicated membership service (host
  registration, the cluster epoch, epoch-fenced writes, watch/poll, a
  warm standby), its TCP server and client; the JAX module with its
  import prefix renamed. The pserver client resolves its shard
  topology from a view (`PServerClient.from_membership`) and the gang
  supervisor mirrors its members into one (`GangSupervisor(
  membership=...)`).
- ``cluster.agent`` -- the per-host agent process: spawns and fences
  its host's replica processes (`serve.fleet.ReplicaProcess`),
  registers them as its inventory, renews its lease, and tears down
  fenced on eviction. It never touches the card; its replicas do.

The agent's names resolve on first use, so `cluster.lease` and
`cluster.membership` users do not load the serving stack.
"""

import importlib

from paddle_tpu_torch.cluster.lease import Lease, LeaseTable
from paddle_tpu_torch.cluster.membership import (ClusterView,
                                                 MembershipClient,
                                                 MembershipServer,
                                                 MembershipService)

_AGENT = ("AgentProcess", "AgentSpec")

__all__ = sorted(["ClusterView", "Lease", "LeaseTable", "MembershipClient",
                  "MembershipServer", "MembershipService", *_AGENT])


def __getattr__(name):
    if name not in _AGENT:
        raise AttributeError(
            f"module 'paddle_tpu_torch.cluster' has no attribute {name!r}")
    value = getattr(importlib.import_module("paddle_tpu_torch.cluster.agent"),
                    name)
    globals()[name] = value
    return value
