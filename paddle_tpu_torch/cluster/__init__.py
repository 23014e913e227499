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

The per-host agent is not ported yet (ROADMAP queue 1 item 6).
"""

from paddle_tpu_torch.cluster.lease import Lease, LeaseTable
from paddle_tpu_torch.cluster.membership import (ClusterView,
                                                 MembershipClient,
                                                 MembershipServer,
                                                 MembershipService)

__all__ = ["ClusterView", "Lease", "LeaseTable", "MembershipClient",
           "MembershipServer", "MembershipService"]
