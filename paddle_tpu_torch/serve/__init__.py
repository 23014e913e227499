"""Serving: the paged decode engine, its reliability server, the
multi-replica router, the process fleet over its socket transport, the
streaming HTTP edge, the serving artifacts, the C-API bridge and CTR
serving over the tiered embedding cache (port of `paddle_tpu.serve`'s
names).

The names (and the `quant` submodule) resolve on first use, so loading
an artifact (`serve.artifact`, `serve.capi_bridge`) imports no model
code, and a process that only spawns and fences replicas
(`serve.fleet.ReplicaProcess`, the per-host agent) imports no torch."""

import importlib

_NAMES = {
    "paddle_tpu_torch.serve.artifact": (
        "ArtifactMismatchError", "CompiledModel", "export_compiled_model",
        "export_decoder", "load_compiled_model", "load_engine_artifact",
        "save_engine_artifact"),
    "paddle_tpu_torch.serve.ctr": ("CtrServer", "init_tower"),
    "paddle_tpu_torch.serve.embed_cache": (
        "CacheBacking", "TieredEmbedCache"),
    "paddle_tpu_torch.serve.fleet": (
        "AutoscalePolicy", "FleetSupervisor", "ReplicaProcess",
        "ReplicaSpec"),
    "paddle_tpu_torch.serve.http_edge": ("HttpEdge",),
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
    "paddle_tpu_torch.serve.transport": (
        "ProcessReplica", "ReplicaClient", "ReplicaTransportServer",
        "TransportCallError", "TransportConnectError", "TransportError"),
}
_MODULE_OF = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = ["quant"] + sorted(_MODULE_OF)


def __getattr__(name):
    if name == "quant":
        return importlib.import_module("paddle_tpu_torch.serve.quant")
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'paddle_tpu_torch.serve' has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value
