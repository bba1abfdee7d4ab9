"""The ResNet family, the port of ``paddle_tpu/vision/models/resnet.py``
(PaddleClas ResNet-50 is the JAX package's BASELINE config #1), NCHW.

The layers and their names are the JAX package's (``conv1``, ``bn1``,
``layer1.0.conv1``, ..., ``downsample.0`` / ``.1``, ``fc``), so its state
dict (267 keys for ``resnet50``: the weights, biases and the BN buffers
``_mean`` / ``_variance``) loads key for key (``convert.py``). The blocks'
``forward`` calls the fused batch norm (K10 on a card): ``bn1`` (and
``bn2`` of a bottleneck) with its ReLU, the last BN with the residual add
and the ReLU, the same function as the JAX package's ``relu(bn(.))`` and
``relu(bn(.) + identity)`` under its casts; the ``relu`` layers stay (no
parameters). Each constructor takes ``device`` (``cuda`` unless
``"cpu"``) and ``seed`` (the initial weights' generator on that device)
besides the JAX package's arguments; ``pretrained=True`` raises (no
weights ship with the port).
"""

from __future__ import annotations

from ... import nn
from ...nn.initializer import XavierUniform
from ...nn.layer import build_scope, scope_state
from ...ops.manipulation import flatten

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
           "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
           "resnext152_32x4d", "resnext152_64x4d", "wide_resnet50_2",
           "wide_resnet101_2"]


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride,
                               padding=1, bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.bn1(self.conv1(x), act="relu")
        return self.bn2(self.conv2(out), residual=identity, act="relu")


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride,
                               padding=dilation, groups=groups,
                               dilation=dilation, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.bn1(self.conv1(x), act="relu")
        out = self.bn2(self.conv2(out), act="relu")
        return self.bn3(self.conv3(out), residual=identity, act="relu")


class ResNet(nn.Layer):
    """``depth`` 18 / 34 (``BasicBlock``) or 50 / 101 / 152
    (``BottleneckBlock``); ``width`` the bottleneck's base width,
    ``groups`` its grouped 3x3 (ResNeXt); the head ``fc`` over the
    average-pooled features where ``num_classes > 0``. Built in the
    current ``nn.build_scope``."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, in_channels=3):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = nn.Conv2D(in_channels, self.inplanes, 7, stride=2,
                               padding=3, bias_attr=False)
        self.bn1 = nn.BatchNorm2D(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            dev, gen = scope_state()
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                device=dev)
            XavierUniform().init_(self.fc.weight, gen)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False),
                nn.BatchNorm2D(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.bn1(self.conv1(x), act="relu"))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _resnet(block, depth, pretrained, device=None, seed=None, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights do not ship with the port: "
                         "load a state dict (convert.py)")
    with build_scope(device, seed):
        return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=32, width=4,
                   **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=64, width=4,
                   **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=32, width=4,
                   **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=64, width=4,
                   **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, groups=32, width=4,
                   **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, groups=64, width=4,
                   **kwargs)
