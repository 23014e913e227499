"""LeNet-style MNIST convnet and the MLP digit classifier, NHWC (port of
`paddle_tpu.models.lenet`)."""

from __future__ import annotations

from paddle_tpu_torch.nn.layers import (BatchNorm, Conv2D, Dense, Flatten,
                                        MaxPool2D)
from paddle_tpu_torch.nn.module import Sequential


def lenet(num_classes: int = 10, *, with_bn: bool = False) -> Sequential:
    def block(features, name):
        layers = [Conv2D(features, 5, padding="SAME",
                         activation=None if with_bn else "relu",
                         name=f"{name}_conv")]
        if with_bn:
            layers.append(BatchNorm(activation="relu", name=f"{name}_bn"))
        layers.append(MaxPool2D(2, name=f"{name}_pool"))
        return layers

    return Sequential(
        block(20, "b1") + block(50, "b2") + [
            Flatten(name="flatten"),
            Dense(500, activation="relu", name="fc1"),
            Dense(num_classes, name="logits"),
        ],
        name="lenet")


def mlp(num_classes: int = 10, hidden=(128, 64)) -> Sequential:
    layers = [Flatten(name="flatten")]
    for i, h in enumerate(hidden):
        layers.append(Dense(h, activation="relu", name=f"fc{i + 1}"))
    layers.append(Dense(num_classes, name="logits"))
    return Sequential(layers, name="mlp")
