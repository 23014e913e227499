"""Gang test/bench support (port of `paddle_tpu.testing.gang`):
training-job builders a CHILD PROCESS can import by name.

A `parallel.launch.GangSpec` carries a `"module:function"` builder
string across the spawn boundary; each gang member imports it and calls
it to build its model, loss, optimizer and batch stream.

- `build_tiny_job`: the chaos-suite trainer job, a tiny deterministic
  MLP classifier with a momentum optimizer (so the ZeRO-sharded
  optimizer state is not trivial) and a seeded numpy batch stream. The
  SAME builder kwargs give the SAME parameter init and the SAME global
  batches in every process and at every gang size, so a reformed gang
  replays the identical stream and only the restore step decides where
  it picks up.
"""

from __future__ import annotations

#: the chaos-suite job geometry: the global batch divides every gang
#: size the tests reform through (4, 2, 1)
TINY_JOB = dict(in_dim=4, hidden=7, classes=3, batch=8)


def build_tiny_job(*, in_dim: int = 4, hidden: int = 7,
                   classes: int = 3, batch: int = 8,
                   lr: float = 0.05, momentum: float = 0.9,
                   noise_seed: int = 1234):
    """Gang-job builder: tiny deterministic MLP + momentum + seeded
    batches. `batch` is the GLOBAL batch size and must divide every
    gang size the job will run at (each rank trains on batch/P rows)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.nn.layers import Dense
    from paddle_tpu_torch.nn.module import Sequential, ShapeSpec
    from paddle_tpu_torch.ops import losses
    from paddle_tpu_torch.optim import optimizers

    model = Sequential([
        Dense(hidden, name="fc", activation="relu"),
        Dense(classes, name="out"),
    ])

    def loss_fn(logits, y):
        return torch.mean(losses.softmax_cross_entropy(logits, y))

    def batches(total_steps: int):
        rng = np.random.RandomState(noise_seed)
        out = []
        for _ in range(total_steps):
            x = rng.randn(batch, in_dim).astype(np.float32)
            y = rng.randint(0, classes, batch).astype(np.int32)
            out.append((x, y))
        return out

    return {
        "model": model,
        "loss_fn": loss_fn,
        "optimizer": optimizers.momentum(lr, momentum),
        "input_specs": (ShapeSpec((batch, in_dim)),),
        "batches": batches,
    }
