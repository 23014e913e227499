"""The port's counterpart of the repo's `__graft_entry__.entry()`: the
flagship image model's forward (ResNet-50, bf16 compute policy, eval
mode) at batch 16, 224x224, on the card.

    python3 -m paddle_tpu_torch.graft_entry
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.nn.module import ShapeSpec

BATCH, HW = 16, 224


def entry(device=None):
    """Return (forward, (params, mstate, x)): forward(params, mstate, x)
    -> logits [16, 1000]. Sets the bf16 compute policy as the default,
    as the JAX entry does. device None means the card (raises without
    one)."""
    dev = resolve_device(device)
    dtypes.set_default_policy(dtypes.bf16_compute_policy())
    model = resnet.resnet(50, num_classes=1000)
    params, mstate = model.init(0, ShapeSpec((BATCH, HW, HW, 3)), device=dev)

    @torch.no_grad()
    def forward(params, mstate, x):
        out, _ = model.apply(params, mstate, x, training=False)
        return out

    x = torch.from_numpy(np.random.RandomState(0).rand(
        BATCH, HW, HW, 3).astype(np.float32)).to(dev)
    return forward, (params, mstate, x)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry forward ok:", tuple(out.shape))
