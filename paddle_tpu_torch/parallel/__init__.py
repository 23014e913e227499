"""Parallelism layers (port of `paddle_tpu.parallel`). Ported so far:
the single-device mixture-of-experts FFN (`moe`). The mesh, data,
tensor, pipeline, sequence and expert parallelism come with the
distributed slice (ROADMAP queue 1 item 5)."""

from paddle_tpu_torch.parallel import moe
from paddle_tpu_torch.parallel.moe import (ECRouting, MoEOutput, Routing,
                                           capacity_for,
                                           expert_choice_ffn,
                                           expert_choice_routing,
                                           gather_combine, init_moe_params,
                                           moe_ffn, scatter_dispatch,
                                           top_k_gating, top_k_routing)

__all__ = ["moe", "ECRouting", "MoEOutput", "Routing", "capacity_for",
           "expert_choice_ffn", "expert_choice_routing", "gather_combine",
           "init_moe_params", "moe_ffn", "scatter_dispatch", "top_k_gating",
           "top_k_routing"]
