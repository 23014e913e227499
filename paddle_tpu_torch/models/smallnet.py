"""SmallNet, the CIFAR-quick benchmark net, NHWC (port of
`paddle_tpu.models.smallnet`: 3 convs with alternating max/avg 3x3/s2
pools, fc64 + fc10)."""

from __future__ import annotations

from paddle_tpu_torch.nn.layers import (AvgPool2D, Conv2D, Dense, Flatten,
                                        MaxPool2D)
from paddle_tpu_torch.nn.module import Sequential


def smallnet(num_classes: int = 10) -> Sequential:
    return Sequential(
        [
            Conv2D(32, 5, padding=2, activation="relu", name="conv1"),
            MaxPool2D(3, stride=2, padding=1, name="pool1"),
            Conv2D(32, 5, padding=2, activation="relu", name="conv2"),
            AvgPool2D(3, stride=2, padding=1, name="pool2"),
            Conv2D(64, 3, padding=1, activation="relu", name="conv3"),
            AvgPool2D(3, stride=2, padding=1, name="pool3"),
            Flatten(name="flatten"),
            Dense(64, activation="relu", name="fc1"),
            Dense(num_classes, name="logits"),
        ],
        name="smallnet")
