"""Training drivers, events, state, the fault-tolerant runtime and the
checkpoint formats (port of `paddle_tpu.train`). The checkpoint names
are exported here as in the JAX package."""

from paddle_tpu_torch.train.checkpoint import (
    CheckpointManager,
    ManifestMismatchError,
    export_inference_artifact,
    load_inference_artifact,
    load_parameters_tar,
    param_tree_hash,
    save_parameters_tar,
)
