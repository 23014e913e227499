"""Serving: the paged decode engine, its reliability server, the
multi-replica router, the serving artifacts, the C-API bridge and CTR
serving over the tiered embedding cache (port of `paddle_tpu.serve`'s
`artifact`, `capi_bridge`, `ctr`, `embed_cache`, `engine`, `paged`,
`policy`, `router`, `server` and `shm_arena` names). The HTTP edge, the
process fleet and its transport are not ported yet (ROADMAP queue 1
item 6).

The names resolve on first use, so loading an artifact
(`serve.artifact`, `serve.capi_bridge`) imports no model code."""

import importlib

from paddle_tpu_torch.serve import quant

_NAMES = {
    "paddle_tpu_torch.serve.artifact": (
        "ArtifactMismatchError", "CompiledModel", "export_compiled_model",
        "export_decoder", "load_compiled_model", "load_engine_artifact",
        "save_engine_artifact"),
    "paddle_tpu_torch.serve.ctr": ("CtrServer", "init_tower"),
    "paddle_tpu_torch.serve.embed_cache": (
        "CacheBacking", "TieredEmbedCache"),
    "paddle_tpu_torch.serve.engine": (
        "DecodeEngine", "DecodeSeed", "EngineState", "PoolStats",
        "PrefillTicket"),
    "paddle_tpu_torch.serve.paged": (
        "PagePool", "PoolExhaustedError", "chain_keys"),
    "paddle_tpu_torch.serve.policy": (
        "RandomRoutingPolicy", "SchedulerPolicy"),
    "paddle_tpu_torch.serve.router": (
        "Replica", "ReplicaDeadError", "RouterResult", "ServingRouter"),
    "paddle_tpu_torch.serve.server": (
        "CircuitBreaker", "MigrationRefusedError", "QueueFullError",
        "Request", "RequestResult", "ServingServer"),
    "paddle_tpu_torch.serve.shm_arena": (
        "ArenaError", "ArenaFull", "ArenaUnavailable", "ShmArena"),
}
_MODULE_OF = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = ["quant"] + sorted(_MODULE_OF)


def __getattr__(name):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'paddle_tpu_torch.serve' has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value
