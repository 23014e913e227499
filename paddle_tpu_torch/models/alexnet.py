"""AlexNet, NHWC (port of `paddle_tpu.models.alexnet`: 5 convs with LRN
after conv1/conv2, 3 fc with dropout; groups=2 as an option)."""

from __future__ import annotations

from paddle_tpu_torch.nn.layers import (LRN, Conv2D, Dense, Dropout, Flatten,
                                        MaxPool2D)
from paddle_tpu_torch.nn.module import Sequential


def alexnet(num_classes: int = 1000, *, groups: int = 1,
            dropout: float = 0.5) -> Sequential:
    return Sequential(
        [
            Conv2D(96, 11, stride=4, padding="VALID", activation="relu",
                   name="conv1"),
            LRN(5, name="lrn1"),
            MaxPool2D(3, stride=2, name="pool1"),
            Conv2D(256, 5, padding="SAME", groups=groups, activation="relu",
                   name="conv2"),
            LRN(5, name="lrn2"),
            MaxPool2D(3, stride=2, name="pool2"),
            Conv2D(384, 3, padding="SAME", activation="relu", name="conv3"),
            Conv2D(384, 3, padding="SAME", groups=groups, activation="relu",
                   name="conv4"),
            Conv2D(256, 3, padding="SAME", groups=groups, activation="relu",
                   name="conv5"),
            MaxPool2D(3, stride=2, name="pool5"),
            Flatten(name="flatten"),
            Dense(4096, activation="relu", name="fc6"),
            Dropout(dropout, name="drop6"),
            Dense(4096, activation="relu", name="fc7"),
            Dropout(dropout, name="drop7"),
            Dense(num_classes, name="logits"),
        ],
        name="alexnet")
