"""Parallelism (port of `paddle_tpu.parallel`) on `torch.distributed`:
sharding rules and the sharded train step on DTensors, the explicit
ZeRO step, the named collectives, ring and Ulysses attention, the GPipe
pipeline (with `tp_axis`), expert-parallel and single-device
mixture-of-experts, the sharded sparse embeddings (`sparse`:
ShardedEmbedding, HostOffloadEmbedding, the all-to-all lookups), the
ring and blocked matmuls (`blocked_matmul`), the process bootstrap
(`distributed`), the launcher with the elastic gang supervisor
(`launch`, imported on use), and the parameter-server client
(`pserver_client`: PServerClient, PServerEmbedding).
"""

from paddle_tpu_torch.parallel.sharding import (
    MEGATRON_RULES,
    batch_sharding,
    make_param_shardings,
    zero_shardings,
)
from paddle_tpu_torch.parallel.train_step import (
    aot_compile_train_step,
    make_sharded_train_step,
    make_zero_train_step,
    opt_state_bytes_per_replica,
    shard_train_state,
    train_state_shardings,
    zero_init_opt_state,
    zero_opt_shardings,
    zero_state_shardings,
    zero_true_sizes,
)
from paddle_tpu_torch.parallel import collectives
# NB: the bare per-rank `ring_attention` fn stays on the submodule --
# re-exporting it here would shadow the `parallel.ring_attention` module.
from paddle_tpu_torch.parallel.ring_attention import (
    dense_attention,
    make_sequence_parallel_attention,
    ulysses_attention,
)
from paddle_tpu_torch.parallel import distributed
from paddle_tpu_torch.parallel import moe
from paddle_tpu_torch.parallel.moe import (ECRouting, MoEOutput, Routing,
                                           capacity_for,
                                           expert_choice_ffn,
                                           expert_choice_routing,
                                           gather_combine, init_moe_params,
                                           make_expert_parallel_ffn,
                                           moe_ffn, scatter_dispatch,
                                           shard_moe_params, top_k_gating,
                                           top_k_routing)
from paddle_tpu_torch.parallel import blocked_matmul
from paddle_tpu_torch.parallel import pipeline
from paddle_tpu_torch.parallel import sparse
from paddle_tpu_torch.parallel.sparse import (
    HostOffloadEmbedding,
    LookupSurface,
    ShardedEmbedding,
    alltoall_lookup,
    alltoall_push_row_grads,
    rowwise_sgd_update,
    shard_rows,
    sharded_embedding_bag,
    sharded_lookup,
    unique_rows_grad,
)
from paddle_tpu_torch.parallel.pserver_client import (
    PServerClient,
    PServerEmbedding,
    PServerError,
    ShardConn,
)
from paddle_tpu_torch.parallel.pipeline import (
    make_pipeline_forward,
    make_pipeline_train_step,
    shard_stage_params,
    stack_stage_params,
)

__all__ = [
    "MEGATRON_RULES", "batch_sharding", "make_param_shardings",
    "zero_shardings", "aot_compile_train_step", "make_sharded_train_step",
    "make_zero_train_step", "opt_state_bytes_per_replica",
    "shard_train_state", "train_state_shardings", "zero_init_opt_state",
    "zero_opt_shardings", "zero_state_shardings", "zero_true_sizes",
    "collectives", "dense_attention", "make_sequence_parallel_attention",
    "ulysses_attention", "distributed", "moe", "ECRouting", "MoEOutput",
    "Routing", "capacity_for", "expert_choice_ffn",
    "expert_choice_routing", "gather_combine", "init_moe_params",
    "make_expert_parallel_ffn", "moe_ffn", "scatter_dispatch",
    "shard_moe_params", "top_k_gating", "top_k_routing", "pipeline",
    "make_pipeline_forward", "make_pipeline_train_step",
    "shard_stage_params", "stack_stage_params", "blocked_matmul", "sparse",
    "HostOffloadEmbedding", "LookupSurface", "ShardedEmbedding",
    "alltoall_lookup", "alltoall_push_row_grads", "rowwise_sgd_update",
    "shard_rows", "sharded_embedding_bag", "sharded_lookup",
    "unique_rows_grad", "PServerClient", "PServerEmbedding",
    "PServerError", "ShardConn",
]
