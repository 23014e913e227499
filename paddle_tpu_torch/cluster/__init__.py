"""Multi-host control plane (port of `paddle_tpu.cluster`).

- ``cluster.lease`` -- the lease table (TTL + renew + expiry, injectable
  clock), copied unchanged from the JAX package (it imports neither jax
  nor numpy); the gang supervisor's heartbeat staleness runs on it.

Membership and the per-host agent are not ported yet (ROADMAP queue 1
item 6).
"""

from paddle_tpu_torch.cluster.lease import Lease, LeaseTable

__all__ = ["Lease", "LeaseTable"]
