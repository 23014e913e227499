"""ResNet family (18/34/50/101/152), NHWC (port of
`paddle_tpu.models.resnet`: the same layers, names and trees)."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.nn.composite import Remat, Residual
from paddle_tpu_torch.nn.layers import (BatchNorm, Conv2D, Dense,
                                        GlobalAvgPool2D, MaxPool2D)
from paddle_tpu_torch.nn.module import Layer, Sequential


def conv_bn(features, kernel, stride, *, activation="relu", name,
            space_to_depth=False):
    """conv + BN (+act) block."""
    return [
        Conv2D(features, kernel, stride=stride, padding="SAME",
               use_bias=False, name=f"{name}_conv",
               space_to_depth=space_to_depth),
        BatchNorm(activation=activation, name=f"{name}_bn"),
    ]


def _shortcut(in_ch: int, out_ch: int, stride: int,
              name: str) -> Optional[Layer]:
    if in_ch == out_ch and stride == 1:
        return None
    return Sequential(conv_bn(out_ch, 1, stride, activation=None,
                              name=f"{name}_proj"), name=f"{name}_sc")


def basic_block(in_ch: int, out_ch: int, stride: int, name: str) -> Layer:
    main = Sequential(
        conv_bn(out_ch, 3, stride, name=f"{name}_a")
        + conv_bn(out_ch, 3, 1, activation=None, name=f"{name}_b"),
        name=f"{name}_main")
    return Residual(main, _shortcut(in_ch, out_ch, stride, name),
                    activation="relu", name=name)


def bottleneck_block(in_ch: int, out_ch: int, stride: int,
                     name: str) -> Layer:
    mid = out_ch // 4
    main = Sequential(
        conv_bn(mid, 1, 1, name=f"{name}_a")
        + conv_bn(mid, 3, stride, name=f"{name}_b")
        + conv_bn(out_ch, 1, 1, activation=None, name=f"{name}_c"),
        name=f"{name}_main")
    return Residual(main, _shortcut(in_ch, out_ch, stride, name),
                    activation="relu", name=name)


_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def resnet(depth: int = 50, num_classes: int = 1000, *, width: int = 64,
           s2d_stem: bool = False, remat: Optional[str] = None) -> Sequential:
    """ImageNet-style ResNet.

    s2d_stem=True computes the 7x7/s2 stem on a 2x2 space-to-depth
    blocking of the input (same parameters, same output). remat wraps
    every residual block in nn.composite.Remat (same trees, same math):
    "conv_out" keeps only the conv outputs for the backward and
    recomputes BN and ReLU; "full" keeps nothing inside a block."""
    if remat not in (None, "conv_out", "full"):
        raise ValueError(
            f"remat must be None, 'conv_out' or 'full', got {remat!r}")
    kind, reps = _SPECS[depth]
    block = basic_block if kind == "basic" else bottleneck_block
    expansion = 1 if kind == "basic" else 4

    def wrap(layer):
        if remat is None:
            return layer
        return Remat(layer, policy="conv_out" if remat == "conv_out" else None)

    layers = conv_bn(width, 7, 2, name="stem", space_to_depth=s2d_stem) + [
        MaxPool2D(3, stride=2, padding="SAME", name="stem_pool")]
    in_ch = width
    for stage, n in enumerate(reps):
        out_ch = width * (2 ** stage) * expansion
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            layers.append(
                wrap(block(in_ch, out_ch, stride, name=f"s{stage}_b{i}")))
            in_ch = out_ch
    layers += [GlobalAvgPool2D(name="gap"), Dense(num_classes, name="logits")]
    return Sequential(layers, name=f"resnet{depth}")


def resnet_cifar(depth: int = 20, num_classes: int = 10, *,
                 width: int = 16) -> Sequential:
    """CIFAR-style 6n+2 ResNet of basic blocks."""
    n = (depth - 2) // 6
    layers = conv_bn(width, 3, 1, name="stem")
    in_ch = width
    for stage in range(3):
        out_ch = width * (2 ** stage)
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            layers.append(basic_block(in_ch, out_ch, stride,
                                      name=f"s{stage}_b{i}"))
            in_ch = out_ch
    layers += [GlobalAvgPool2D(name="gap"), Dense(num_classes, name="logits")]
    return Sequential(layers, name=f"resnet{depth}_cifar")
