"""GoogLeNet (Inception v1), NHWC (port of `paddle_tpu.models.googlenet`;
the paper's auxiliary towers are left out, as there).

The three 1x1 convs of an inception block (the direct branch and the
3x3/5x5 reducers) read the same input, so `Inception` computes them as
one conv over their concatenated kernels. Its parameter tree is the
plain `Branches` expression's (`_inception_branches`, kept as the
reference it is tested against)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtypes import default_policy
from paddle_tpu_torch.nn.composite import Branches
from paddle_tpu_torch.nn.layers import (LRN, Conv2D, Dense, Dropout,
                                        GlobalAvgPool2D, MaxPool2D)
from paddle_tpu_torch.nn.module import Layer, Sequential, ShapeSpec
from paddle_tpu_torch.ops import conv as conv_ops


def _inception_branches(name, c1, c3r, c3, c5r, c5, proj) -> Layer:
    """The plain combinator expression (one conv per branch)."""
    return Branches(
        [
            Conv2D(c1, 1, activation="relu", name=f"{name}_1x1"),
            Sequential([
                Conv2D(c3r, 1, activation="relu", name=f"{name}_3x3r"),
                Conv2D(c3, 3, padding="SAME", activation="relu",
                       name=f"{name}_3x3"),
            ], name=f"{name}_b3"),
            Sequential([
                Conv2D(c5r, 1, activation="relu", name=f"{name}_5x5r"),
                Conv2D(c5, 5, padding="SAME", activation="relu",
                       name=f"{name}_5x5"),
            ], name=f"{name}_b5"),
            Sequential([
                MaxPool2D(3, stride=1, padding=1, name=f"{name}_poolp"),
                Conv2D(proj, 1, activation="relu", name=f"{name}_proj"),
            ], name=f"{name}_bp"),
        ],
        name=name)


class Inception(Layer):
    """Inception block computing the three same-input 1x1 convs as one
    concatenated-kernel conv; its init is `_inception_branches`'."""

    def __init__(self, c1, c3r, c3, c5r, c5, proj, *, name):
        self.sizes = (c1, c3r, c3, c5r, c5, proj)
        self.name = name
        self._plain = _inception_branches(name, c1, c3r, c3, c5r, c5, proj)
        self.branches = self._plain.branches

    def _key(self, suffix):
        return f"{self.name}_{suffix}"

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        return self._plain._init(rng, spec, _abstract=_abstract)

    def _apply(self, params, state, x, *, training: bool, rng):
        c1, c3r, c3, c5r, c5, proj = self.sizes
        policy = default_policy()
        p1 = params[self._key("1x1")]
        p3r = params[self._key("b3")][self._key("3x3r")]
        p3 = params[self._key("b3")][self._key("3x3")]
        p5r = params[self._key("b5")][self._key("5x5r")]
        p5 = params[self._key("b5")][self._key("5x5")]
        pp = params[self._key("bp")][self._key("proj")]

        # one conv for every 1x1 that reads x directly
        k = torch.cat([p1["kernel"], p3r["kernel"], p5r["kernel"]], dim=-1)
        b = torch.cat([p1["bias"], p3r["bias"], p5r["bias"]])
        y = torch.relu(conv_ops.conv2d(x, k, bias=b, policy=policy))
        y1 = y[..., :c1]
        y3r = y[..., c1:c1 + c3r]
        y5r = y[..., c1 + c3r:]
        y3 = torch.relu(conv_ops.conv2d(y3r, p3["kernel"], padding="SAME",
                                        bias=p3["bias"], policy=policy))
        y5 = torch.relu(conv_ops.conv2d(y5r, p5["kernel"], padding="SAME",
                                        bias=p5["bias"], policy=policy))
        pooled = conv_ops.max_pool2d(x, 3, stride=1, padding=1)
        yp = torch.relu(conv_ops.conv2d(pooled, pp["kernel"], bias=pp["bias"],
                                        policy=policy))
        return torch.cat([y1, y3, y5, yp], dim=-1), {}


def googlenet(num_classes: int = 1000, *, dropout: float = 0.4) -> Sequential:
    inc = lambda name, *sizes: Inception(*sizes, name=name)
    return Sequential(
        [
            Conv2D(64, 7, stride=2, padding="SAME", activation="relu",
                   name="conv1"),
            MaxPool2D(3, stride=2, padding="SAME", name="pool1"),
            LRN(5, name="lrn1"),
            Conv2D(64, 1, activation="relu", name="conv2r"),
            Conv2D(192, 3, padding="SAME", activation="relu", name="conv2"),
            LRN(5, name="lrn2"),
            MaxPool2D(3, stride=2, padding="SAME", name="pool2"),
            inc("i3a", 64, 96, 128, 16, 32, 32),
            inc("i3b", 128, 128, 192, 32, 96, 64),
            MaxPool2D(3, stride=2, padding="SAME", name="pool3"),
            inc("i4a", 192, 96, 208, 16, 48, 64),
            inc("i4b", 160, 112, 224, 24, 64, 64),
            inc("i4c", 128, 128, 256, 24, 64, 64),
            inc("i4d", 112, 144, 288, 32, 64, 64),
            inc("i4e", 256, 160, 320, 32, 128, 128),
            MaxPool2D(3, stride=2, padding="SAME", name="pool4"),
            inc("i5a", 256, 160, 320, 32, 128, 128),
            inc("i5b", 384, 192, 384, 48, 128, 128),
            GlobalAvgPool2D(name="gap"),
            Dropout(dropout, name="drop"),
            Dense(num_classes, name="logits"),
        ],
        name="googlenet")
