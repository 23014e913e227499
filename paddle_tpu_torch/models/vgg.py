"""VGG family (11/13/16/19), NHWC (port of `paddle_tpu.models.vgg`:
stacks of 3x3 convs (with BN by default) and 2x2 pools, two fc layers
with dropout)."""

from __future__ import annotations

from paddle_tpu_torch.nn.layers import (BatchNorm, Conv2D, Dense, Dropout,
                                        Flatten, MaxPool2D)
from paddle_tpu_torch.nn.module import Sequential

_CFG = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


def vgg(depth: int = 16, num_classes: int = 1000, *, with_bn: bool = True,
        fc_dim: int = 4096, dropout: float = 0.5) -> Sequential:
    reps = _CFG[depth]
    layers = []
    ch = 64
    for stage, n in enumerate(reps):
        for i in range(n):
            name = f"s{stage}_c{i}"
            if with_bn:
                layers += [
                    Conv2D(ch, 3, padding="SAME", use_bias=False,
                           name=f"{name}_conv"),
                    BatchNorm(activation="relu", name=f"{name}_bn"),
                ]
            else:
                layers.append(Conv2D(ch, 3, padding="SAME",
                                     activation="relu", name=f"{name}_conv"))
        layers.append(MaxPool2D(2, name=f"s{stage}_pool"))
        ch = min(ch * 2, 512)
    layers += [
        Flatten(name="flatten"),
        Dense(fc_dim, activation="relu", name="fc6"),
        Dropout(dropout, name="drop6"),
        Dense(fc_dim, activation="relu", name="fc7"),
        Dropout(dropout, name="drop7"),
        Dense(num_classes, name="logits"),
    ]
    return Sequential(layers, name=f"vgg{depth}")
