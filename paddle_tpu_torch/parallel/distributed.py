"""Multi-process bootstrap and cross-process coordination (port of
`paddle_tpu.parallel.distributed`) on `torch.distributed`.

`initialize` joins the job's default process group: NCCL on the card,
gloo on the CPU (or a backend the caller names). With no arguments and
no cluster environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`) it is a
no-op, the single-process case; with explicit arguments a failure
propagates. JAX's `_enable_cpu_collectives` has no counterpart: gloo is
the CPU backend.

Single-process runs need none of this: every helper is a no-op at world
size 1. `ensure_initialized` starts a world-size-1 group over an
in-process store where a mesh needs one and none exists.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map

_CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _backend(device, backend: Optional[str]) -> str:
    if backend is not None:
        return backend
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _set_card(device) -> None:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None,
               backend: Optional[str] = None) -> None:
    """Join the multi-process job: call it before anything else.

    coordinator_address: "host:port" (a TCP rendezvous) or a URL
    (`tcp://`, `file://`). With explicit arguments, failures propagate
    (the caller asked for a cluster). With none, the cluster environment
    decides: without RANK, WORLD_SIZE and MASTER_ADDR this is the
    single-process case and returns; with them the group starts from
    the environment and its failures propagate. device None -> cuda
    (NCCL; raises without a card); "cpu" -> gloo; `backend` overrides
    (gloo on CUDA tensors runs two ranks on one card)."""
    if dist.is_initialized():
        return
    auto = (coordinator_address is None and num_processes is None
            and process_id is None)
    if auto:
        if not all(k in os.environ for k in _CLUSTER_ENV):
            return
        dist.init_process_group(_backend(device, backend),
                                init_method="env://")
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("pass coordinator_address, num_processes and "
                             "process_id together")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(_backend(device, backend), init_method=url,
                                world_size=int(num_processes),
                                rank=int(process_id))
    _set_card(device)


def ensure_initialized(device=None) -> None:
    """A default process group for a mesh: the job's (`initialize`), or
    else one process over an in-process store (world size 1, no
    network)."""
    initialize(device=device)
    if not dist.is_initialized():
        dist.init_process_group(_backend(device, None),
                                store=dist.HashStore(), rank=0,
                                world_size=1)
        _set_card(device)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0,
    deterministic rather than elected)."""
    return process_index() == 0


def sync_hosts(name: str = "sync") -> None:
    """Cross-process barrier."""
    if process_count() <= 1:
        return
    dist.barrier()


def broadcast_from_primary(tree):
    """Make process-local values identical everywhere by broadcasting
    the primary's copy: tensors by a tensor broadcast on their own device
    (no host copy), anything else by an object broadcast."""
    if process_count() <= 1:
        return tree

    def bcast(leaf):
        if isinstance(leaf, torch.Tensor):
            out = leaf.detach().clone()
            dist.broadcast(out, src=0)
            return out
        box = [leaf]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    return tree_map(bcast, tree)


def abort(reason: str, exit_code: int = 75) -> None:
    """Force-exit THIS process at once (`os._exit`: no atexit, no flush
    of device work): the one way out of a wedged collective, whose wait
    neither an exception nor a signal reaches. Under gang scheduling a
    non-zero exit restarts the job into its checkpoint-resume path."""
    logging.getLogger(__name__).critical(
        "aborting process %d: %s", os.getpid(), reason)
    try:
        sys.stderr.write(f"paddle_tpu_torch ABORT: {reason}\n")
        sys.stderr.flush()
    except Exception:
        pass
    os._exit(exit_code)


def replicated_agree(value) -> bool:
    """A process-local value (a tensor or host scalar/array) equals the
    primary's (a data-parallel determinism check; True single-process)."""
    if process_count() <= 1:
        return True
    ref = broadcast_from_primary(value)
    if isinstance(value, torch.Tensor):
        return bool(torch.equal(value, ref))
    import numpy as np

    return bool(np.all(np.asarray(value) == np.asarray(ref)))
