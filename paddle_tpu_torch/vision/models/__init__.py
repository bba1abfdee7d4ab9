"""Vision models of the port: the ResNet family
(``paddle_tpu/vision/models/resnet.py``; the JAX package's other vision
models wait, ROADMAP.md A17)."""

from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
           "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
           "resnext152_32x4d", "resnext152_64x4d", "wide_resnet50_2",
           "wide_resnet101_2"]
