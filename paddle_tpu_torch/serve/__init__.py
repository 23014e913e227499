"""Serving: the paged decode engine, its reliability server and the
multi-replica router (port of `paddle_tpu.serve`'s `engine`, `paged`,
`policy`, `router`, `server` and `shm_arena` names). The serving
artifacts, the HTTP edge, the process fleet and its transport are not
ported yet (ROADMAP queue 1 items 4 and 6)."""

from paddle_tpu_torch.serve import quant
from paddle_tpu_torch.serve.engine import (DecodeEngine, DecodeSeed,
                                           EngineState, PoolStats,
                                           PrefillTicket)
from paddle_tpu_torch.serve.paged import (PagePool, PoolExhaustedError,
                                          chain_keys)
from paddle_tpu_torch.serve.policy import (RandomRoutingPolicy,
                                           SchedulerPolicy)
from paddle_tpu_torch.serve.router import (Replica, ReplicaDeadError,
                                           RouterResult, ServingRouter)
from paddle_tpu_torch.serve.server import (CircuitBreaker,
                                           MigrationRefusedError,
                                           QueueFullError, Request,
                                           RequestResult, ServingServer)
from paddle_tpu_torch.serve.shm_arena import (ArenaError, ArenaFull,
                                              ArenaUnavailable, ShmArena)
